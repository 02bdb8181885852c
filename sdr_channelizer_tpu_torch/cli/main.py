"""CLI entry point of the port: ``generate``, ``pdw`` (wideband, or
channelized with ``--channelized``) and ``pdw --stream [--channelized]``.

The other workflows of the JAX package's CLI are not ported yet and exit
with an error that says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import numpy as np


def _not_ported(what: str) -> "SystemExit":
    return SystemExit(f"error: not ported yet: {what}")


def cmd_generate(args) -> int:
    """generate_training_iq.m parity: random (or explicit) pulse trains
    written as v1 .iq with the ground truth encoded in the filename
    (``generate_training_iq.m:107``)."""
    from sdr_channelizer_tpu_torch.signal import synth

    os.makedirs(args.out_dir, exist_ok=True)
    for k in range(args.count):
        if args.freq_mhz is None:
            spec = synth.random_pulse_train_spec(
                args.seed + k, sample_rate_sps=args.fs_msps * 1e6,
                duration_sec=args.duration_sec,
            )
        else:
            spec = synth.PulseTrainSpec(
                sample_rate_sps=args.fs_msps * 1e6,
                duration_sec=args.duration_sec,
                frequency_hz=args.freq_mhz * 1e6,
                pulse_width_sec=args.pw_us * 1e-6,
                pri_sec=args.pri_us * 1e-6,
                noise_std=args.noise_std,
            )
        name = (f"{spec.frequency_hz/1e6:.1f}_MHz_{spec.pulse_width_sec*1e6:.1f}"
                f"_us_{spec.pri_sec*1e6:.1f}_us.iq")
        path = os.path.join(args.out_dir, name)
        synth.write_training_iq(path, spec, seed=args.seed + k)
        print(path)
    return 0


def _bands_for(args, fs: float) -> int:
    from sdr_channelizer_tpu_torch.config import bands_for_bin_width

    if args.bands:
        return args.bands
    return bands_for_bin_width(fs, args.bin_width_hz)


def _save_pdws(args, all_pdws) -> int:
    merged = {k: np.concatenate([p[k] for p in all_pdws]) for k in all_pdws[0]}
    order = np.argsort(merged["toa"], kind="stable")
    merged = {k: v[order] for k, v in merged.items()}
    out = args.out or "pdw.npz"
    np.savez(out, **merged)
    print(out)
    return 0


def _pdw_stream(args) -> int:
    """Blockwise streaming extraction over contiguous multi-file capture
    segments (``dsp/streaming.py``): O(block) memory, exact two-pass noise
    floor, optional checkpoint/resume.  The path for capture series and for
    files too large for one device buffer."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.dsp.streaming import (
        CaptureSet,
        StreamingExtractor,
    )
    from sdr_channelizer_tpu_torch.utils.metrics import Counters

    counters = Counters()
    all_pdws = []
    cset = CaptureSet.from_paths([os.fspath(p) for p in args.files])
    for si, seg in enumerate(cset.segments):
        hdr = seg.headers[0]
        fs = hdr.sample_rate_sps
        make_cfg = PdwConfig.channelized if args.channelized \
            else PdwConfig.wideband
        cfg = make_cfg(max_pulses=args.max_pulses,
                       max_pulse_samples=args.max_pulse_samples)
        if args.threshold_db is not None:
            cfg = dataclasses.replace(cfg, snr_threshold_db=args.threshold_db)
        chan = Channelizer.create(_bands_for(args, fs)) if args.channelized \
            else None
        ext = StreamingExtractor(channelizer=chan, pdw_cfg=cfg,
                                 block_frames=args.block_frames,
                                 counters=counters, device=args.device)
        ck = (os.path.join(args.checkpoint_dir, f"seg{si:03d}")
              if args.checkpoint_dir else None)
        # Channelized segments take the packed block path through the
        # kernels; wideband segments the plain PyTorch block path.
        run = ext.extract_segment_fused if chan is not None \
            else ext.extract_segment
        pdws = run(seg, fc=hdr.frequency_hz, checkpoint_dir=ck)
        all_pdws.append(pdws)
        print(f"segment {si} ({len(seg.paths)} files, "
              f"{seg.num_samples} samples): {len(pdws['toa'])} pulses")
    counters.add("files_processed", len(args.files))
    if args.metrics:
        print(counters.to_json())
    return _save_pdws(args, all_pdws)


def cmd_pdw(args) -> int:
    """create_pdws.m parity (wideband) and, with ``--channelized``,
    create_pdws_channelized.m parity through the packed main path, for
    integer-payload ``.iq`` files; with ``--stream``, blockwise over
    contiguous multi-file segments."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.io.convert import load_capture_raw
    from sdr_channelizer_tpu_torch.models import (
        ChannelizerPipeline,
        WidebandPdwPipeline,
    )

    if args.shards > 1:
        raise _not_ported("pdw --shards (multi-device extraction)")
    if args.stream:
        return _pdw_stream(args)

    all_pdws = []
    for path in args.files:
        try:
            raw, bw, meta = load_capture_raw(path)
        except NotImplementedError as e:
            raise SystemExit(f"error: {e}")
        if raw.dtype not in (np.int16, np.int8):
            raise _not_ported(f"{raw.dtype} payloads ({path})")
        fs = float(meta["fs"])
        fc = float(meta.get("fc", 0.0))
        t0 = float(meta.get("sampleStartTime", 0.0))
        if not args.channelized:
            cfg = PdwConfig.wideband(max_pulses=args.max_pulses,
                                     max_pulse_samples=args.max_pulse_samples)
            if args.threshold_db is not None:
                cfg = dataclasses.replace(cfg,
                                          snr_threshold_db=args.threshold_db)
            pipe = WidebandPdwPipeline(pdw_cfg=cfg, device=args.device)
            pdws = pipe.extract(iqpacket.to_complex(raw, bw), fs=fs, fc=fc,
                                sample_start_time=t0)
            all_pdws.append(pdws)
            print(f"{path}: {len(pdws['toa'])} pulses")
            continue
        m = _bands_for(args, fs)
        cfg = PdwConfig.channelized(max_pulses=args.max_pulses,
                                    max_pulse_samples=args.max_pulse_samples)
        if args.threshold_db is not None:
            cfg = dataclasses.replace(cfg, snr_threshold_db=args.threshold_db)
        pipe = ChannelizerPipeline.create(m, pdw_cfg=cfg, device=args.device)
        n = len(raw) // m * m
        pdws = pipe.extract_fused(raw[:n], bit_width=bw, fs=fs, fc=fc,
                                  sample_start_time=t0)
        all_pdws.append(pdws)
        print(f"{path}: {len(pdws['toa'])} pulses")
    return _save_pdws(args, all_pdws)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sdr_channelizer_tpu_torch",
        description="wideband channelizer + pulse-detection framework "
                    "(PyTorch/CUDA port)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate", help="write synthetic training .iq captures")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--count", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fs-msps", type=float, default=56.0)
    p.add_argument("--duration-sec", type=float, default=100e-3)
    p.add_argument("--freq-mhz", type=float, default=None,
                   help="fix the tone frequency (default: random per file)")
    p.add_argument("--pw-us", type=float, default=100.0)
    p.add_argument("--pri-us", type=float, default=1000.0)
    p.add_argument("--noise-std", type=float, default=0.0)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("pdw", help="extract pulse descriptor words")
    p.add_argument("files", nargs="+")
    p.add_argument("--channelized", action="store_true")
    p.add_argument("--bands", type=int, default=None)
    p.add_argument("--bin-width-hz", type=float, default=1e6)
    p.add_argument("--threshold-db", type=float, default=None)
    p.add_argument("--max-pulses", type=int, default=512)
    p.add_argument("--max-pulse-samples", type=int, default=4096)
    p.add_argument("--shards", type=int, default=1,
                   help="(not ported yet) multi-device extraction")
    p.add_argument("--stream", action="store_true",
                   help="blockwise streaming extraction over contiguous "
                        "multi-file segments (O(block) memory, exact "
                        "two-pass noise floor); with --channelized through "
                        "the kernels, without it wideband in plain PyTorch")
    p.add_argument("--block-frames", type=int, default=65536,
                   help="frames per streaming block (--stream)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-block checkpoint/resume directory (--stream)")
    p.add_argument("--metrics", action="store_true",
                   help="print a structured-counters JSON line (--stream)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device (an error "
                        "when there is none); 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_pdw)

    args = ap.parse_args(argv)
    return args.fn(args)
