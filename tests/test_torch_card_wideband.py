"""The wideband paths on the card: ``WidebandPdwPipeline.extract`` on
16,000,000 complex samples (the fused one-channel streams, K2's floor, the
time-major latch and the statistics at one channel) against its plain run
and the generator's pulses, its staged step bit for bit the eager one, and
its kernels one by one against their plain versions; 2^25 samples through
the blocked route (the flip a block) against the oracle extractor, each
block's step staged and eager bit for bit; ``predict`` on eight 80 ms
dwells at 56 Msps written by the recorder, in-process against its plain
run and through the CLI in a process of its own; and the closed-loop
tracker, 20 dense dwells synthesised on the card, staged and eager.

Marked ``card``: skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_wideband.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_card_fixtures import (
    DENSE_SCENE, DEVICE, DWELL_SEC, EVENT_FS, EVENT_MAG_RTOL, FREQ_TOL_HZ,
    MAG_TOL, PREDICT_FILES, PREDICT_WINDOW, REPO, SCAN, SNR_TOL_DB,
    TRACK_DWELLS, WIDE_FS, WIDE_LONG_SAMPLES, WIDE_SAMPLES, check, max_abs,
    off_boundary, outputs_identical, pdws_agree, pdws_identical, read_counts,
    reset_counts, same, wideband_capture)
from torch_card_fixtures import card  # noqa: F401  (fixture)

pytestmark = pytest.mark.card

WIDEBAND_COUNTS = {
    "noise_floor_wideband": "nf_kernel.launches",
    "latch_cumsums_wideband": "latch_kernel.launches_tm",
    "wideband_streams": "transpose_kernel.launches_wideband",
    "cm_streams_wideband": "transpose_kernel.launches",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}


@pytest.fixture(scope="module")
def wide(card):
    """The wideband pipeline, ``PdwConfig.wideband(512, 4096)``, and its
    config."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline

    cfg = PdwConfig.wideband(max_pulses=512, max_pulse_samples=4096)
    return WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg),
                                              DEVICE), cfg


def test_wideband_16m(wide):
    """16,000,000 samples through ``extract`` on the card: its kernels
    launched (the fused streams, no flip), the PDWs bit for bit the plain
    run's and the generator's pulses; the step with the capture on the
    card staged and eager; the fused streams on the capture and off a
    16-byte boundary, K2, B7 and B8 at one channel against their plain
    versions."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.signal.synth import pulse_starts

    pipe, cfg = wide
    n = WIDE_SAMPLES
    spec, iq = wideband_capture(n, 1e-3, 1234, seed=3)
    t0 = 100.0   # an epoch time would cost float64 a sample's worth of TOA

    reset_counts(WIDEBAND_COUNTS)
    got = pipe.extract(iq, fs=WIDE_FS, sample_start_time=t0)
    torch.cuda.synchronize()
    launches = read_counts(WIDEBAND_COUNTS)
    # the single-shot step makes its streams with the fused form: no flip
    for name, count in launches.items():
        check(count == 0 if name == "cm_streams_wideband" else count > 0,
              f"wideband: launch counts {launches}")

    plain = pipe.extract(iq, fs=WIDE_FS, sample_start_time=t0, plain=True)
    pdws_agree(got, plain, "wideband, kernels vs plain")
    pdws_identical(got, plain, "wideband, kernels vs plain")
    for key in ("toa", "freq", "pw", "mag", "snr"):
        check(bool(np.isfinite(got[key]).all()), f"wideband: non-finite {key}")
    starts = pulse_starts(spec)
    check(len(got["toa"]) == len(starts) > 200,
          f"wideband: {len(got['toa'])} pulses, {len(starts)} generated")
    toa_err = np.abs((got["toa"] - t0) * WIDE_FS - (starts + 1))
    pw_err = np.abs(got["pw"] * WIDE_FS - spec.pw_samples)
    f_err = np.abs(got["freq"] - spec.frequency_hz)
    check(float(toa_err.max()) <= 1.0, f"wideband: TOA off the generator's "
                                       f"by {toa_err.max():.3g} samples")
    check(float(pw_err.max()) <= 16.0, f"wideband: width off the "
                                       f"generator's by {pw_err.max():.3g}")
    check(float(f_err.max()) <= 2e3, f"wideband: frequency off the "
                                     f"generator's by {f_err.max():.3g} Hz")

    # the step with the capture on the card, eager and staged (bit for bit
    # the same), and its parts one by one
    x = torch.as_tensor(iq, device=DEVICE)
    outputs_identical(pipe.step(x), pipe.forward(x),
                      "wideband 16M: staged step vs eager")
    level = cfg.saturation_level
    mag, ph, sat = pdwmod._prep_streams(x, level)
    # the fused one-channel streams, on the capture (16-byte loads) and on a
    # copy one sample off a 16-byte boundary (a pair a load), bit for bit
    # the plain chain
    fused = k.wideband_streams_plain(x, level)
    check(same(fused[0], mag), "wideband_streams: mag is not |x|")
    for loads, xs in (("16-byte", x), ("pair", off_boundary(x))):
        streams = k.wideband_streams(xs, level)
        check(all(same(a, b) for a, b in zip(streams, fused)),
              f"wideband_streams 16M, {loads} loads: differs from plain")
    del streams
    row1 = mag[None]   # the capture's magnitude as K2's one row
    nf = k.noise_floor_cm(row1, n)
    nf_plain = k.noise_floor_cm_plain(row1, n)
    check(same(nf, nf_plain), f"K2 wideband shape: off by "
                              f"{max_abs(nf, nf_plain):.3g}")
    check(same(nf.reshape(()), pipe.forward(x)[0]),
          "wideband: the step's floor is not K2's")
    nf = nf.reshape(())
    lead, trail = (t.reshape(1) for t in pdwmod._thresholds(
        nf, cfg.snr_threshold_db, cfg.trailing_threshold_db))
    mag2, ph2, sat2 = mag[:, None], ph[:, None], sat[:, None]

    # B7 at one channel
    a = k.latch_cumsums(mag2, lead, trail)
    b = k.latch_cumsums_plain(mag2, lead, trail)
    check(same(a, b), f"B7 wideband shape: off by {max_abs(a, b):.3g}")
    check(int(a[0, -1]) == len(starts), "B7 wideband shape: edge count")
    del a, b

    # B8 at one channel on the whole 16M capture: mag_cm is a view of mag
    a = k.cm_streams(mag2, ph2, sat2)
    check(all(same(u, v) for u, v in
              zip(a, k.cm_streams_plain(mag2, ph2, sat2)))
          and a[0].data_ptr() == mag2.data_ptr(),
          "B8 at M = 1 x 16M: differs from plain")


def test_wideband_blocked(wide):
    """2^25 samples: the blocked route, B8 a block.  One pulse straddles
    the first block boundary, one clips, one is open at the end of the
    capture.  Its launches counted, K2's floor its plain version's, the
    staged step (a graph a block key) bit for bit the eager one and, on
    the second call, all replays; the PDWs against the oracle extractor;
    B8 at one channel as the blocked path calls it (the first, a middle
    and the last block, and the first off a 16-byte boundary)."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.signal.synth import pulse_starts

    pipe, cfg = wide
    level = cfg.saturation_level
    n = WIDE_LONG_SAMPLES
    block = 1 << 23
    pri_n = 112000
    spec, iq = wideband_capture(n, pri_n / WIDE_FS, (block - 1400) % pri_n,
                                seed=4)
    starts = pulse_starts(spec)
    check(bool(np.any((starts < block) & (starts + spec.pw_samples > block))),
          "wideband, blocked: no pulse straddles the block boundary")
    clip = starts[len(starts) // 2]
    iq[clip:clip + spec.pw_samples] = 1.0
    iq[-1000:] = 0.5
    x = torch.as_tensor(iq, device=DEVICE)
    del iq
    reset_counts(WIDEBAND_COUNTS)
    nf, batch = pipe.forward(x)
    torch.cuda.synchronize()
    blocked_launches = read_counts(WIDEBAND_COUNTS)
    n_blocks = n // block
    check(blocked_launches["latch_cumsums_wideband"] == n_blocks
          and blocked_launches["cm_streams_wideband"] == n_blocks
          and blocked_launches["wideband_streams"] == 0
          and blocked_launches["noise_floor_wideband"] == 1,
          f"wideband, blocked: launch counts {blocked_launches}")
    check(same(nf.reshape(1), k.noise_floor_cm_plain(x.abs()[None], n)),
          "K2 at 2^25 samples: differs from plain")
    # the staged step: each block's step a graph (two keys: the blocks with
    # a halo, the last with its +inf pad), bit for bit the eager step; on
    # the second call every block a replay, B8 at one channel in each
    blk_step = pipe._staged_block
    outputs_identical(pipe.step(x), (nf, batch),
                      "wideband, blocked: staged step vs eager")
    reset_counts(WIDEBAND_COUNTS)
    outputs_identical(pipe.step(x), (nf, batch),
                      "wideband, blocked: staged step, all replays")
    replay_launches = read_counts(WIDEBAND_COUNTS)
    check((blk_step.hits, blk_step.misses, len(blk_step))
          == (2 * n_blocks - 2, 2, 2)
          and replay_launches == blocked_launches,
          f"wideband, blocked: staged hits, misses {blk_step.hits}, "
          f"{blk_step.misses}, launches {replay_launches}")
    ref = pdwmod.extract_pdws(x, cfg, noise_floor=nf, stats="xla")
    got_b, ref_b = pdwmod.batch_to_host(batch), pdwmod.batch_to_host(ref)
    for key in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid", "count"):
        check(np.array_equal(getattr(got_b, key), getattr(ref_b, key)),
              f"wideband, blocked vs the oracle: {key} differs")
    check(np.allclose(got_b.mag, ref_b.mag, rtol=MAG_TOL, atol=MAG_TOL)
          and np.allclose(got_b.snr_db, ref_b.snr_db, rtol=0, atol=SNR_TOL_DB)
          and np.allclose(got_b.freq_offset_hz * WIDE_FS,
                          ref_b.freq_offset_hz * WIDE_FS, rtol=0,
                          atol=FREQ_TOL_HZ),
          "wideband, blocked vs the oracle: statistics differ")
    count = int(got_b.count)
    check(count == len(starts), f"wideband, blocked: {count} pulses, "
                                f"{len(starts)} closed ones generated")
    check(int(got_b.saturated.sum()) == 1, "wideband, blocked: the clipped "
                                           "pulse is not the one flagged")
    # B8 at one channel as the blocked path calls it, each bit for bit the
    # plain version: the first block's views (2^23 + halo samples from the
    # capture's start), a middle block's (from sample 2^23) and the last
    # block's fresh tensors (2^23 + 1 samples, T % 4 = 1: the +inf pad);
    # and the first on a copy one element off a 16-byte boundary (the
    # 4-byte loads)
    mag, ph, sat = pdwmod._prep_streams(x, level)
    h1 = block + cfg.max_pulse_samples
    s_last = (n_blocks - 1) * block
    shapes = {
        "first": tuple(t[0:h1][:, None] for t in (mag, ph, sat)),
        "middle": tuple(t[block:block + h1][:, None] for t in (mag, ph, sat)),
        "last": tuple(torch.cat([t[s_last:], pad])[:, None] for t, pad in (
            (mag, mag.new_full((1,), float("inf"))), (ph, ph.new_zeros(1)),
            (sat, sat.new_zeros(1)))),
    }
    shapes["first_off_boundary"] = tuple(off_boundary(t)
                                         for t in shapes["first"])
    for where, streams in shapes.items():
        a = k.cm_streams(*streams)
        check(all(same(u, v) for u, v in
                  zip(a, k.cm_streams_plain(*streams)))
              and a[0].data_ptr() == streams[0].data_ptr(),
              f"B8 blocked path, {where} block (T={streams[0].shape[0]}): "
              f"differs from plain")


def test_predict(card, tmp_path):
    """``predict`` on the card: eight consecutive 80 ms dwells of the
    scanning beam at 56 Msps written by the port's recorder; its kernels
    launched (the fused streams once a dwell and once for the capture, no
    flip, the long-window statistics); in-process bit for bit its plain
    run, the event near the beam's 0.1 s; the CLI in a process of its own
    prints the same lines; each dwell's staged step bit for bit the eager
    one, one capture for the shared shape."""
    from sdr_channelizer_tpu_torch.capture import EmulatedRadio
    from sdr_channelizer_tpu_torch.cli.main import predict_files, record_dwells
    from sdr_channelizer_tpu_torch.config import CaptureConfig, PdwConfig
    from sdr_channelizer_tpu_torch.io.convert import load_capture
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    rec = CaptureConfig(frequency_mhz=1000.0, bandwidth_mhz=EVENT_FS / 1e6,
                        sample_rate_msps=EVENT_FS / 1e6, rx_gain_db=60.0,
                        dwell_sec=DWELL_SEC,
                        duration_sec=PREDICT_FILES * DWELL_SEC)
    cfg = PdwConfig.event(max_pulses=512, max_pulse_samples=PREDICT_WINDOW)
    counts = {"noise_floor": "nf_kernel.launches",
              "latch_cumsums": "latch_kernel.launches_tm",
              "wideband_streams": "transpose_kernel.launches_wideband",
              "cm_streams": "transpose_kernel.launches",
              "pulse_stats_dense": "pulse_stats_kernel.launches_dense",
              "pulse_stats_long_window":
                  "pulse_stats_kernel.launches_long_window"}
    tmp = str(tmp_path)
    radio = EmulatedRadio(sample_rate_sps=EVENT_FS, **SCAN,
                          start_epoch=1723800000.0)
    files = record_dwells(radio, rec, tmp)
    check(len(files) == PREDICT_FILES, f"predict: {len(files)} files")

    reset_counts(counts)
    records, pred, base = predict_files(files, cfg, device=DEVICE)
    torch.cuda.synchronize()
    launches = read_counts(counts)
    # every dwell makes its streams with the fused form, and none flips;
    # the dwells share one shape, so the staged step captures once, its
    # eager warm-up one launch more
    check(launches["wideband_streams"] == PREDICT_FILES + 1
          and launches["cm_streams"] == 0
          and all(n > 0 for key, n in launches.items()
                  if key != "cm_streams"),
          f"predict: launch counts {launches}")
    plain, pred_plain, _ = predict_files(files, cfg, device=DEVICE,
                                         plain=True)
    for (path, p, ev, nxt), (_, q, ev_q, nxt_q) in zip(records, plain):
        pdws_identical(p, q, f"predict {os.path.basename(path)}, "
                             f"kernels vs plain")
        check(ev == ev_q and nxt == nxt_q,
              f"predict {os.path.basename(path)}: event differs from "
              f"the plain run")
    check(pred.events == pred_plain.events, "predict: events differ")
    check(len(pred.events) >= 1 and min(abs(e - 0.1) for e in
                                        pred.events) < 0.02,
          f"predict: no event within 0.02 s of 0.1 s: {pred.events}")
    widths = np.concatenate([p["pw"] for _, p, _, _ in records])
    check(widths.size > 0 and float(widths.max()) * EVENT_FS + 1
          <= psk.BLOCK_KEYS,
          "predict: a pulse longer than a select block's shared memory")

    # the CLI in a process of its own: the same lines
    res = subprocess.run(
        [sys.executable, "-m", "sdr_channelizer_tpu_torch", "predict",
         *files], capture_output=True, text=True, timeout=600, cwd=REPO)
    check(res.returncode == 0, f"predict CLI: exit {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    want = [f"{path}: event at +{ev:.6f}s, next predicted +{nxt:.6f}s"
            if nxt is not None else f"{path}: gated out / too few pulses"
            for path, _, ev, nxt in records]
    got_lines = res.stdout.splitlines()
    check(got_lines[:len(want)] == want,
          f"predict CLI: lines differ from the in-process run: "
          f"{got_lines[:3]} vs {want[:3]}")

    # per file on the card: the capture loaded, then extract (its step
    # staged: the first file's call captures it), then the dwell's
    # staged step against the eager one, bit for bit
    pipe = WidebandPdwPipeline(cfg, DEVICE)
    for path in files:
        iq, meta = load_capture(path)
        pipe.extract(iq, fs=float(meta["fs"]))
        outputs_identical(pipe.step(iq), pipe.forward(iq),
                          f"predict {os.path.basename(path)}: staged "
                          f"step vs eager")
    check(pipe._staged_forward.misses == 1,
          f"predict: {pipe._staged_forward.misses} captures for one "
          f"dwell shape")


def test_track(card):
    """The closed loop on the card: ``EventTracker`` on
    ``DeviceDwellEmitter`` in the dense scene, 20 dwells of 80 ms at 56
    Msps, the dwell staged, then the same 20 with the dwell eager: the same
    reports, one capture; the scan phase recovered; one dwell's event core
    on the card against the CPU."""
    from sdr_channelizer_tpu_torch.capture import (
        DeviceDwellEmitter, EventTracker)
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod

    class EagerTracker(EventTracker):
        """The tracker with its dwell's device work run eagerly."""

        def _device_dwell(self, xr, xi):
            return self.extract_planes(xr, xi)

    def tracker(cls=EventTracker):
        return cls(radio=DeviceDwellEmitter(
            sample_rate_sps=EVENT_FS, **DENSE_SCENE, device=DEVICE),
            dwell_sec=DWELL_SEC, device=DEVICE)

    warm = tracker()
    warm.run(2)  # warm-up: allocator, first launches, the dwell's capture
    tracker(EagerTracker).run(2)
    runs = {}
    for label in ("staged", "eager"):
        tr = tracker(EagerTracker if label == "eager" else EventTracker)
        if label == "staged":
            # the warm-up's staged dwell, captured at this tracker's key
            tr._staged_dwell = warm._staged_dwell
        runs[label] = tr, [tr.step() for _ in range(TRACK_DWELLS)]
    check(warm._staged_dwell.misses == 1,
          f"track: {warm._staged_dwell.misses} captures for one dwell shape")
    check(runs["staged"][1] == runs["eager"][1],
          "track: the staged dwells' reports differ from the eager ones")
    ev = np.asarray(runs["staged"][0].events)
    check(ev.size > 0, "track: no event fitted")
    period = SCAN["scan_period_sec"]
    err = np.abs(((ev - SCAN["scan_phase_sec"] + period / 2) % period)
                 - period / 2)
    check(float(np.median(err)) < 0.02,
          f"track: median phase error {float(np.median(err)):.4f} s")

    n = int(round(DWELL_SEC * EVENT_FS))
    (xr, xi), _ = DeviceDwellEmitter(sample_rate_sps=EVENT_FS, **DENSE_SCENE,
                                     device=DEVICE).receive(n, start_time=0.06)
    cfg = PdwConfig.event()
    a = pdwmod.batch_to_host(pdwmod.extract_pdws_event_planes(xr, xi, cfg))
    b = pdwmod.batch_to_host(pdwmod.extract_pdws_event_planes(
        xr.cpu(), xi.cpu(), cfg))
    for key in ("toa_idx", "te_idx", "count", "valid", "saturated"):
        check(np.array_equal(getattr(a, key), getattr(b, key)),
              f"track: event core {key} differs between card and CPU")
    check(np.allclose(a.mag, b.mag, rtol=EVENT_MAG_RTOL, atol=0),
          "track: event core mag differs between card and CPU")
    check(int(a.count) > 100, f"track: {int(a.count)} pulses in a dense dwell")
