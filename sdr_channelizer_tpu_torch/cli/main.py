"""CLI entry point of the port, one subcommand per reference workflow:
``generate``, ``record``, ``gain-search``, ``convert``, ``channelize``,
``pdw`` (wideband, or channelized with ``--channelized``; ``--stream``
blockwise over multi-file segments), ``predict``, ``track``, ``txrx``,
``spectrogram``, ``plot`` and ``provision``.  Every command that reads a
capture takes ``.iq``, ``.npz``, ``.mat`` (v5 and v7.3) and legacy ``.bin``
files; the commands that compute run on the CUDA device unless ``--device
cpu`` is given.

``pdw --shards N`` extracts over N time shards (``parallel``): on the first
N CUDA devices, or all N on one card where the machine has fewer than N
(the JAX package refuses that case), or on the CPU with ``--device cpu``.
``bench`` runs the port's benchmark (``sdr_channelizer_tpu_torch.bench``)
in this process; its flags follow ``--`` (``bench -- --stages``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np


def _out_path(in_path: str, out_dir: Optional[str], new_ext: str) -> str:
    base = os.path.basename(in_path)
    stem = base.rsplit(".", 1)[0]
    d = out_dir or os.path.dirname(in_path) or "."
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, stem + new_ext)


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


def cmd_record(args) -> int:
    """The recorders' 7-arg contract against the emulator (the native binary
    if built, else the in-process radio).  Host only: nothing runs on the
    card."""
    from sdr_channelizer_tpu_torch.capture.emulator import (
        EmulatedRadio,
        NativeEmulator,
    )
    from sdr_channelizer_tpu_torch.config import CaptureConfig

    cfg = CaptureConfig(
        frequency_mhz=args.freq_mhz, bandwidth_mhz=args.bw_mhz,
        sample_rate_msps=args.rate_msps, rx_gain_db=args.gain_db,
        dwell_sec=args.dwell_sec, duration_sec=args.duration_sec,
        filter_delay_samples=args.filter_delay, bit_width=args.bit_width,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    native = NativeEmulator()
    if native.available() and not args.python_emulator:
        files = native.record(cfg, args.out_dir, offset_mhz=args.offset_mhz,
                              pw_us=args.pw_us, pri_us=args.pri_us,
                              noise_db=args.noise_db)
        for f in files:
            print(f)
        return 0
    import time

    radio = EmulatedRadio(
        sample_rate_sps=cfg.sample_rate_sps, tone_offset_hz=args.offset_mhz * 1e6,
        pulse_width_sec=args.pw_us * 1e-6, pri_sec=args.pri_us * 1e-6,
        noise_db=args.noise_db, gain_db=cfg.rx_gain_db,
        bit_width=cfg.bit_width, start_epoch=time.time(),
    )
    for path in record_dwells(radio, cfg, args.out_dir):
        print(path)
    if args.metrics:
        print(radio.counters.to_json())
    return 0


def record_dwells(radio, cfg, out_dir: str) -> List[str]:
    """The in-process recorder: ``duration / dwell`` dwells of ``radio``
    (the :class:`~sdr_channelizer_tpu_torch.capture.hardware.Receiver`
    protocol), each written as a v3 ``.iq`` file named by its UTC start
    time after dropping ``filter_delay_samples``; returns the paths."""
    from sdr_channelizer_tpu_torch.capture.hardware import DwellError
    from sdr_channelizer_tpu_torch.io import iqpacket

    paths = []
    n_dwells = int(cfg.duration_sec / cfg.dwell_sec)
    for _ in range(n_dwells):
        try:
            iq, t0 = radio.receive(cfg.dwell_samples + cfg.filter_delay_samples)
        except DwellError as e:
            # drop-don't-corrupt (usrp_record_iq_12bit.cpp:201-227): log,
            # count, keep looping; only whole dwells are written
            print(f"dwell dropped: {e}", file=sys.stderr)
            radio.counters.add(f"dwell_errors_{e.code}")
            continue
        iq = iq[cfg.filter_delay_samples:]
        t0 += cfg.filter_delay_samples / cfg.sample_rate_sps
        samples = iqpacket.from_complex(iq, cfg.bit_width)
        hdr = iqpacket.IqHeader(
            frequency_hz=cfg.frequency_mhz * 1e6, bandwidth_hz=cfg.bandwidth_mhz * 1e6,
            sample_rate_sps=cfg.sample_rate_sps, rx_gain_db=cfg.rx_gain_db,
            num_samples=len(iq), bit_width=cfg.bit_width, sample_start_time=t0,
            board_name="emulated-py", serial_number="emu0",
        )
        path = os.path.join(out_dir, iqpacket.utc_filename(t0))
        iqpacket.write_iq(path, hdr, samples)
        paths.append(path)
    return paths


def cmd_gain_search(args) -> int:
    """Max-unsaturated-gain search against the emulated radio (host only)."""
    from sdr_channelizer_tpu_torch.capture import (
        EmulatedRadio,
        find_max_unsaturated_gain,
    )
    from sdr_channelizer_tpu_torch.utils.metrics import Counters

    radio = EmulatedRadio(
        sample_rate_sps=args.rate_msps * 1e6, tone_offset_hz=args.offset_mhz * 1e6,
        gain_db=args.gain_db, rel_amplitude=args.amplitude, noise_db=args.noise_db,
    )
    dwell_n = int(args.dwell_sec * radio.sample_rate_sps)
    n = int(args.duration_sec / args.dwell_sec)
    counters = Counters()
    final, history = find_max_unsaturated_gain(radio, dwell_n, n,
                                               counters=counters)
    for gain, sat in history:
        print(f"gain {gain:5.1f} dB  {'SATURATED' if sat else 'ok'}")
    print(f"Max unsaturated gain: {final:.1f} dB")
    if args.metrics:
        print(counters.to_json())
    return 0


def cmd_convert(args) -> int:
    """convert_my_iq_to_mat.m / convert_iq_to_mat.m parity: ``.iq`` ->
    ``.npz`` (or ``.mat`` with ``--mat``, v7.3 with ``--v73``), normalised
    or with ``--raw`` the integer payload; legacy ``.bin`` -> ``.npz``."""
    from sdr_channelizer_tpu_torch.io import convert

    for path in args.files:
        if path.endswith(".bin"):
            iq, fs, fc, idx = convert.read_legacy_bin(path)
            out = _out_path(path, args.out_dir, ".npz")
            np.savez(out, iq=iq, fs=fs, fc=fc, index=idx)
        elif args.mat:
            out = _out_path(path, args.out_dir, ".mat")
            convert.iq_to_mat(path, out, normalize=not args.raw,
                              v73=args.v73)
        else:
            out = _out_path(path, args.out_dir, ".npz")
            convert.iq_to_npz(path, out, normalize=not args.raw)
        print(out)
    return 0


def _bands_for(args, fs: float) -> int:
    from sdr_channelizer_tpu_torch.config import bands_for_bin_width

    if args.bands:
        return args.bands
    return bands_for_bin_width(fs, args.bin_width_hz)


def cmd_channelize(args) -> int:
    """channelizer_example.m parity: channelize and render the waterfall.
    On the card the channelizer kernel's complex form runs on the capture's
    two float32 planes and the complex spectra are assembled on the host;
    on the CPU the FFT oracle runs."""
    from sdr_channelizer_tpu_torch._device import resolve_device
    from sdr_channelizer_tpu_torch.dsp.channelizer import (
        Channelizer,
        channelize,
        channelize_planes,
    )
    from sdr_channelizer_tpu_torch.io.convert import load_capture

    device = resolve_device(args.device)
    for path in args.files:
        iq, meta = load_capture(path)
        fs = float(meta["fs"])
        m = _bands_for(args, fs)
        chan = Channelizer.create(m, taps_per_band=args.taps_per_band)
        n = len(iq) // m * m
        if device.type == "cuda":
            yr, yi = channelize_planes(
                np.ascontiguousarray(np.real(iq[:n]), np.float32),
                np.ascontiguousarray(np.imag(iq[:n]), np.float32),
                chan, device=device)
            y = yr.cpu().numpy() + 1j * yi.cpu().numpy()
        else:
            y = channelize(iq[:n], chan, method="fft", device=device).numpy()
        if args.out or len(args.files) == 1:
            out = args.out or _out_path(path, args.out_dir, "_chan.npz")
            np.savez(out, chan_iq=y, fs=fs / m,
                     center_frequencies=chan.center_frequencies(fs) + meta.get("fc", 0.0),
                     sample_start_time=meta.get("sampleStartTime", 0.0))
            print(out)
        if args.png:
            from sdr_channelizer_tpu_torch.viz import waterfall_png

            png = args.png if args.png != "auto" else _out_path(path, args.out_dir, "_waterfall.png")
            waterfall_png(png, np.abs(y), fs, meta.get("fc", 0.0),
                          title=os.path.basename(path))
            print(png)
        if args.frames_dir or args.video:
            import tempfile

            from sdr_channelizer_tpu_torch.viz import waterfall_window_pngs

            frames_dir = args.frames_dir or tempfile.mkdtemp(
                prefix="waterfall_frames_")
            frames = waterfall_window_pngs(
                frames_dir, iq[:n], fs, m, meta.get("fc", 0.0),
                window_sec=args.frame_window_sec, limit=args.frame_limit,
                device=device,
            )
            if args.frames_dir:
                for p in frames:
                    print(p)
            if args.video:
                from sdr_channelizer_tpu_torch.viz import waterfall_video

                video = (args.video if args.video != "auto"
                         else _out_path(path, args.out_dir, "_waterfall.mp4"))
                print(waterfall_video(video, frames, fps=args.video_fps))
    return 0


def _save_pdws(args, all_pdws) -> int:
    merged = {k: np.concatenate([p[k] for p in all_pdws]) for k in all_pdws[0]}
    order = np.argsort(merged["toa"], kind="stable")
    merged = {k: v[order] for k, v in merged.items()}
    out = args.out or "pdw.npz"
    np.savez(out, **merged)
    print(out)
    if args.png:
        from sdr_channelizer_tpu_torch.viz import pdw_plot_png

        pdw_plot_png(args.png, merged)
        print(args.png)
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
        print(_metrics_line(counters))
    return _save_pdws(args, all_pdws)


def _shard_mesh(args):
    """``--shards N``: N time shards on the first N CUDA devices, or all N
    on the one card when the machine has fewer than N, or on the CPU with
    ``--device cpu``."""
    import torch

    from sdr_channelizer_tpu_torch import resolve_device
    from sdr_channelizer_tpu_torch.parallel import make_mesh

    n = args.shards
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index in (None, 0) \
            and torch.cuda.device_count() >= n:
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [dev] * n
    return make_mesh(n_time=n, n_chan=1, devices=devices)


def _pdw_sharded_channelized(args, raw, bw, iq, m, cfg, fs, fc, t0) -> dict:
    """Channelized extraction over ``--shards`` time shards: the fused
    sharded step (the packed payload where there is one, else float32
    planes), the capture cut to whole frames of every shard."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline

    spipe = ShardedPipeline(
        _shard_mesh(args), Channelizer.create(m), cfg,
        halo_mode="strict" if args.strict_halo else "warn")
    k = args.shards * m
    if raw is not None:
        samples = raw[: len(raw) // k * k]
    else:
        n = len(iq) // k * k
        samples = np.stack([iq[:n].real, iq[:n].imag], -1).astype(np.float32)
    return spipe.extract_fused(samples, bit_width=bw, fs=fs, fc=fc,
                               sample_start_time=t0)


def _pdw_sharded_wideband(args, x, cfg, fs, fc, t0) -> dict:
    """Wideband extraction over ``--shards`` time shards, the capture cut
    to a multiple of the shard count."""
    from sdr_channelizer_tpu_torch.dsp.pdw import finalize_pdws
    from sdr_channelizer_tpu_torch.parallel.pipeline import (
        merge_block_batches,
        sharded_extract_pdws,
    )

    n = len(x) // args.shards * args.shards
    batch, block_len = sharded_extract_pdws(x[:n], cfg, _shard_mesh(args),
                                            strict_halo=args.strict_halo)
    return finalize_pdws(merge_block_batches(batch, block_len), fs=fs, fc=fc,
                         sample_start_time=t0)


def _metrics_line(counters) -> str:
    """``--metrics``' JSON line: the counters' snapshot, the program's
    spans by name (``count``, ``total_s``, ``self_s``) and its span
    counters (``utils.profiling``)."""
    import json

    from sdr_channelizer_tpu_torch.utils import profiling

    recorded = profiling.snapshot()
    line = counters.snapshot()
    line["spans"] = recorded["spans"]
    line["span_counters"] = recorded["counters"]
    return json.dumps(line, sort_keys=True)


def cmd_pdw(args) -> int:
    """create_pdws.m parity (wideband) and, with ``--channelized``,
    create_pdws_channelized.m parity, for every capture container: an
    integer payload (``.iq``, a raw ``.npz`` or ``.mat``) goes packed
    through the main path (``extract_fused``), a float one (a normalised
    ``.npz`` or ``.mat``, a legacy ``.bin``) through ``extract``; with
    ``--stream``, blockwise over contiguous multi-file ``.iq`` segments.
    ``--metrics`` records the program's spans over the run and prints them
    with the counters."""
    from sdr_channelizer_tpu_torch.utils import profiling

    if not args.metrics:
        return _pdw(args)
    profiling.enable()
    try:
        return _pdw(args)
    finally:
        profiling.disable()


def _pdw(args) -> int:
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.io.convert import load_capture_payload
    from sdr_channelizer_tpu_torch.models import (
        ChannelizerPipeline,
        WidebandPdwPipeline,
    )
    from sdr_channelizer_tpu_torch.utils.metrics import Counters

    if args.stream:
        return _pdw_stream(args)

    counters = Counters()
    all_pdws = []
    for path in args.files:
        raw, bw, iq, meta = load_capture_payload(path)
        if raw is not None and raw.dtype not in (np.int16, np.int8):
            # a wider integer payload: dequantize on the host, after which
            # there is no bit width left to scale by
            raw, iq, bw = None, iqpacket.to_complex(raw, bw), 0
        fs = float(meta["fs"])
        fc = float(meta.get("fc", 0.0))
        t0 = float(meta.get("sampleStartTime", 0.0))
        if not args.channelized:
            cfg = PdwConfig.wideband(max_pulses=args.max_pulses,
                                     max_pulse_samples=args.max_pulse_samples)
            if args.threshold_db is not None:
                cfg = dataclasses.replace(cfg,
                                          snr_threshold_db=args.threshold_db)
            x = iqpacket.to_complex(raw, bw) if raw is not None else iq
            if args.shards > 1:
                pdws = _pdw_sharded_wideband(args, x, cfg, fs, fc, t0)
            else:
                pipe = WidebandPdwPipeline(pdw_cfg=cfg, device=args.device)
                pdws = pipe.extract(x, fs=fs, fc=fc, sample_start_time=t0)
            all_pdws.append(pdws)
            print(f"{path}: {len(pdws['toa'])} pulses")
            continue
        m = _bands_for(args, fs)
        cfg = PdwConfig.channelized(max_pulses=args.max_pulses,
                                    max_pulse_samples=args.max_pulse_samples)
        if args.threshold_db is not None:
            cfg = dataclasses.replace(cfg, snr_threshold_db=args.threshold_db)
        if args.shards > 1:
            pdws = _pdw_sharded_channelized(args, raw, bw, iq, m, cfg, fs, fc,
                                            t0)
            all_pdws.append(pdws)
            print(f"{path}: {len(pdws['toa'])} pulses ({args.shards} shards)")
            continue
        pipe = ChannelizerPipeline.create(m, pdw_cfg=cfg, device=args.device)
        if raw is not None:
            n = len(raw) // m * m
            pdws = pipe.extract_fused(raw[:n], bit_width=bw, fs=fs, fc=fc,
                                      sample_start_time=t0)
        else:
            n = len(iq) // m * m
            pdws = pipe.extract(iq[:n], fs=fs, fc=fc, sample_start_time=t0)
        all_pdws.append(pdws)
        print(f"{path}: {len(pdws['toa'])} pulses")
    counters.add("files_processed", len(args.files))
    if args.metrics:
        print(_metrics_line(counters))
    return _save_pdws(args, all_pdws)


def predict_files(paths, cfg, device=None, plain: bool = False):
    """``predict_event.m``'s loop over captures: wideband extraction of each
    file (``WidebandPdwPipeline``, TOAs relative to the first file's start),
    then the per-file quadratic fit and the next-event estimate.  Returns
    ``(records, predictor, base_time)``, a record ``(path, pdws, event,
    next_event)`` per file, ``event`` and ``next_event`` None where the file
    was gated out or had too few pulses.  ``plain=True`` runs the kernels'
    plain versions on the same device, for checking one against the
    other."""
    from sdr_channelizer_tpu_torch.dsp.events import EventPredictor
    from sdr_channelizer_tpu_torch.io.convert import load_capture
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline

    pipe = WidebandPdwPipeline(pdw_cfg=cfg, device=device)
    pred = EventPredictor()
    base_time = None
    records = []
    for path in paths:
        iq, meta = load_capture(path)
        t0 = float(meta.get("sampleStartTime", 0.0))
        if base_time is None:
            base_time = t0
        pdws = pipe.extract(iq, fs=float(meta["fs"]),
                            sample_start_time=t0 - base_time, plain=plain)
        nxt = pred.update(pdws["toa"], pdws["snr"],
                          max_abs_iq=float(np.max(np.abs(iq))))
        records.append((path, pdws, None if nxt is None else pred.events[-1],
                        nxt))
    return records, pred, base_time


def cmd_predict(args) -> int:
    """predict_event.m parity: per-file quadratic fits -> next-event time;
    with ``--png`` the ``predict_event.m:140-150`` plot."""
    from sdr_channelizer_tpu_torch.config import PdwConfig

    cfg = PdwConfig.event(max_pulses=args.max_pulses,
                          max_pulse_samples=args.max_pulse_samples)
    records, pred, base_time = predict_files(args.files, cfg,
                                             device=args.device)
    next_event = None
    all_toa: list = []
    all_snr: list = []
    for path, pdws, event, nxt in records:
        if nxt is not None:
            next_event = nxt
            # the reference plot accumulates the fitted captures' pulse
            # samples (predict_event.m:146-148)
            all_toa.extend(np.asarray(pdws["toa"], float).tolist())
            all_snr.extend(np.asarray(pdws["snr"], float).tolist())
            print(f"{path}: event at +{event:.6f}s, "
                  f"next predicted +{nxt:.6f}s")
        else:
            print(f"{path}: gated out / too few pulses")
    if next_event is not None:
        print(f"Next event: {base_time + next_event:.6f} (epoch)")
        if args.png:
            from sdr_channelizer_tpu_torch.viz import event_fit_png

            event_fit_png(args.png, np.asarray(all_toa), np.asarray(all_snr),
                          event_time=pred.events[-1],
                          next_event_time=next_event,
                          fits=np.asarray(pred.fits, float))
    return 0


def cmd_track(args) -> int:
    """usrp_predict_event parity against the emulated radio."""
    from sdr_channelizer_tpu_torch.capture import EmulatedRadio, EventTracker

    radio = EmulatedRadio(
        sample_rate_sps=args.rate_msps * 1e6, tone_offset_hz=args.offset_mhz * 1e6,
        pulse_width_sec=args.pw_us * 1e-6, pri_sec=args.pri_us * 1e-6,
        gain_db=args.gain_db, rel_amplitude=args.amplitude, noise_db=args.noise_db,
        scan_period_sec=args.scan_period_sec, scan_phase_sec=args.scan_phase_sec,
        scan_curvature_db_per_s2=args.scan_curvature,
    )
    tracker = EventTracker(radio=radio, dwell_sec=args.dwell_sec,
                           device=args.device)
    n = int(args.duration_sec / args.dwell_sec)
    for rep in tracker.run(n):
        line = (f"t={rep.start_time:9.3f}s pulses={rep.num_pulses:4d} "
                f"gain={rep.gain_db:5.1f}dB")
        if rep.event_time is not None:
            line += f" event={rep.event_time:9.3f}s"
        if rep.next_event_time is not None:
            line += f" next={rep.next_event_time:9.3f}s"
        if rep.saturated:
            line += " SATURATED"
        print(line)
    if args.metrics:
        import json

        print(json.dumps({"tracker": tracker.counters.snapshot(),
                          "radio": radio.counters.snapshot()}, sort_keys=True))
    return 0


def cmd_txrx(args) -> int:
    """tx_rx_pulses parity: timed pulse bursts through the loopback channel,
    both sides written as .iq (host only)."""
    from sdr_channelizer_tpu_torch.capture.txrx import TxRxSpec, run_txrx

    spec = TxRxSpec(
        sample_rate_sps=args.rate_msps * 1e6,
        chip_width_sec=args.chip_width_sec,
        pri_sec=args.pri_sec,
        duration_sec=args.duration_sec,
        barker13=args.barker13,
        frequency_hz=args.freq_mhz * 1e6,
        delay_samples=args.delay_samples,
        attenuation_db=args.attenuation_db,
        noise_std=args.noise_std,
    )
    tx_path, rx_path = run_txrx(spec, args.out_dir)
    print(tx_path)
    print(rx_path)
    return 0


def cmd_spectrogram(args) -> int:
    """spectrogram_my_iq.m parity: one STFT power PNG per capture.  Integer
    payloads go to the device packed (``stft_power_packed``), float
    containers as complex samples (``stft_power``)."""
    from sdr_channelizer_tpu_torch.config import SpectrogramConfig
    from sdr_channelizer_tpu_torch.dsp.spectrogram import (
        save_png,
        stft_power,
        stft_power_packed,
    )
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.io.convert import load_capture_payload

    cfg = SpectrogramConfig(window_length=args.window)
    for path in args.files:
        samples, bit_width, iq, meta = load_capture_payload(path)
        if samples is not None and samples.dtype in (np.int16, np.int8):
            samples = np.ascontiguousarray(samples)
            packed = (samples.view(np.int32) if samples.dtype == np.int16
                      else samples.view(np.int16)).ravel()
            power = stft_power_packed(packed, bit_width, cfg=cfg,
                                      device=args.device)
        else:
            if samples is not None:  # a wider integer payload
                iq = iqpacket.to_complex(samples, bit_width)
            power = stft_power(iq, cfg=cfg, device=args.device)
        out = _out_path(path, args.out_dir, "_spectrogram.png")
        save_png(out, power.cpu().numpy(), float(meta["fs"]),
                 float(meta.get("fc", 0.0)), cfg=cfg,
                 title=os.path.basename(path))
        print(out)
    return 0


def cmd_plot(args) -> int:
    """plot_my_iq.m parity: magnitude and phase against time, a PNG per
    capture (host only)."""
    from sdr_channelizer_tpu_torch.io.convert import load_capture
    from sdr_channelizer_tpu_torch.viz import plot_iq_png

    for path in args.files:
        iq, meta = load_capture(path)
        out = _out_path(path, args.out_dir, "_iq.png")
        plot_iq_png(out, iq, float(meta["fs"]), title=os.path.basename(path))
        print(out)
    return 0


def cmd_provision(args) -> int:
    """loadFpgaA5/loadFpgaA9 parity: bladeRF FPGA bitstream + firmware load
    via bladeRF-cli (reference component #12)."""
    from sdr_channelizer_tpu_torch.capture.hardware import (
        provision_bladerf,
        provision_bladerf_commands,
    )

    if args.dry_run:
        for cmd in provision_bladerf_commands(args.board, args.workarea):
            print(" ".join(cmd))
        return 0
    return provision_bladerf(args.board, args.workarea)


def cmd_bench(args) -> int:
    from sdr_channelizer_tpu_torch import bench

    return bench.main(args.bench_args)


def _add_capture_args(p):
    p.add_argument("--metrics", action="store_true",
                   help="print a structured-counters JSON line at exit")
    p.add_argument("freq_mhz", type=float)
    p.add_argument("bw_mhz", type=float)
    p.add_argument("rate_msps", type=float)
    p.add_argument("gain_db", type=float)
    p.add_argument("dwell_sec", type=float)
    p.add_argument("duration_sec", type=float)
    p.add_argument("--offset-mhz", type=float, default=5.0)
    p.add_argument("--pw-us", type=float, default=100.0)
    p.add_argument("--pri-us", type=float, default=1000.0)
    p.add_argument("--noise-db", type=float, default=-60.0)
    p.add_argument("--amplitude", type=float, default=1.0)


def _add_device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device (an error "
                        "when there is none); 'cpu' runs the plain PyTorch "
                        "versions of the kernels")


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

    p = sub.add_parser("record", help="emulated recorder (7-arg CLI contract)")
    _add_capture_args(p)
    p.add_argument("filter_delay", type=int, nargs="?", default=0)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--bit-width", type=int, default=12)
    p.add_argument("--python-emulator", action="store_true")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("gain-search", help="max-unsaturated-gain search")
    _add_capture_args(p)
    p.set_defaults(fn=cmd_gain_search)

    p = sub.add_parser("convert", help=".iq/.bin -> .npz or .mat")
    p.add_argument("files", nargs="+")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--mat", action="store_true")
    p.add_argument("--v73", action="store_true",
                   help="with --mat: write a v7.3 (HDF5) container like the "
                        "reference's save -v7.3")
    p.add_argument("--raw", action="store_true", help="keep integer payload")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("channelize", help="polyphase channelize + waterfall")
    p.add_argument("files", nargs="+")
    p.add_argument("--bands", type=int, default=None)
    p.add_argument("--bin-width-hz", type=float, default=1e6)
    p.add_argument("--taps-per-band", type=int, default=12)
    p.add_argument("--out", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--png", default=None, const="auto", nargs="?")
    p.add_argument("--video", default=None, nargs="?", const="auto",
                   help="assemble the windowed waterfall into an MPEG-4 "
                        "(channelizer_example.m video parity); optional "
                        "output path")
    p.add_argument("--video-fps", type=float, default=20.0)
    p.add_argument("--frames-dir", default=None,
                   help="write a waterfall PNG sequence (video parity)")
    p.add_argument("--frame-window-sec", type=float, default=5e-3)
    p.add_argument("--frame-limit", type=int, default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_channelize)

    p = sub.add_parser("pdw", help="extract pulse descriptor words")
    p.add_argument("files", nargs="+")
    p.add_argument("--channelized", action="store_true")
    p.add_argument("--bands", type=int, default=None)
    p.add_argument("--bin-width-hz", type=float, default=1e6)
    p.add_argument("--threshold-db", type=float, default=None)
    p.add_argument("--max-pulses", type=int, default=512)
    p.add_argument("--max-pulse-samples", type=int, default=4096)
    p.add_argument("--shards", type=int, default=1,
                   help="extract over N time shards: on the first N CUDA "
                        "devices, or all N on one card when the machine has "
                        "fewer (the JAX package refuses that), or on the "
                        "CPU with --device cpu; ignored with --stream.  "
                        "The shards' kernels are launched from one Python "
                        "loop, so at a capture that fits one card this is "
                        "slower than --shards 1")
    p.add_argument("--strict-halo", action="store_true",
                   help="with --shards: refuse a halo that does not fit the "
                        "per-shard block")
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
                   help="print a JSON line of the counters and the "
                        "program's spans")
    _add_device_arg(p)
    p.add_argument("--out", default=None)
    p.add_argument("--png", default=None,
                   help="also plot frequency and width against TOA")
    p.set_defaults(fn=cmd_pdw)

    p = sub.add_parser("predict", help="offline event prediction over captures")
    p.add_argument("files", nargs="+")
    p.add_argument("--max-pulses", type=int, default=512)
    p.add_argument("--max-pulse-samples", type=int, default=65536)
    p.add_argument("--png", default=None,
                   help="plot the fitted pulses, the fits and the events")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("track", help="closed-loop event tracker (emulated)")
    _add_capture_args(p)
    p.add_argument("--scan-period-sec", type=float, default=0.5)
    p.add_argument("--scan-phase-sec", type=float, default=0.1)
    p.add_argument("--scan-curvature", type=float, default=2000.0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("txrx", help="pulsed TX/RX loopback (emulated channel)")
    p.add_argument("freq_mhz", type=float)
    p.add_argument("bw_mhz", type=float)
    p.add_argument("rate_msps", type=float)
    p.add_argument("gain_db", type=float)
    p.add_argument("dwell_sec", type=float)
    p.add_argument("duration_sec", type=float)
    p.add_argument("chip_width_sec", type=float)
    p.add_argument("pri_sec", type=float)
    p.add_argument("--barker13", action="store_true")
    p.add_argument("--delay-samples", type=int, default=100)
    p.add_argument("--attenuation-db", type=float, default=20.0)
    p.add_argument("--noise-std", type=float, default=1e-3)
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_txrx)

    p = sub.add_parser("spectrogram", help="STFT power PNG per capture")
    p.add_argument("files", nargs="+")
    p.add_argument("--window", type=int, default=768)
    p.add_argument("--out-dir", default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_spectrogram)

    p = sub.add_parser("plot", help="magnitude/phase PNG per capture")
    p.add_argument("files", nargs="+")
    p.add_argument("--out-dir", default=None)
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser("provision",
                       help="bladeRF FPGA/firmware provisioning (loadFpgaA5/A9)")
    p.add_argument("board", choices=["A5", "A9"])
    p.add_argument("--workarea", default="~/workarea")
    p.add_argument("--dry-run", action="store_true",
                   help="print the bladeRF-cli commands without running them")
    p.set_defaults(fn=cmd_provision)

    p = sub.add_parser(
        "bench", help="the benchmark (sdr_channelizer_tpu_torch.bench); "
                      "its flags after --, as in: bench -- --stages")
    p.add_argument("bench_args", nargs="*",
                   help="arguments of sdr_channelizer_tpu_torch.bench, "
                        "after --")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)
