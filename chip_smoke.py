#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the port's
main path (packed int16 capture -> channelizer -> noise floor -> latch ->
pulse statistics -> PDWs) at its real size, M = 64 bands x 262144 frames,
then the streamed path (four contiguous ``.iq`` files of 16,777,216 samples
each -> blocks of 65536 frames through the channelizer's cm form, the
time-major latch and the statistics with the saturation mask, with
checkpoint and resume) and holds it against single-shot extraction of the
same samples; then the wideband path (``WidebandPdwPipeline`` on 16,000,000
complex samples through the fused one-channel streams, the time-major latch
and the statistics at one channel, and 33,554,432 samples block by block,
the flip kernel a block, against the oracle extractor), the single-shot
routes ``"flat"`` and ``"cm"`` against
``"cm2"``, float payloads and the complex-free step; then the batched
statistics kernel on the main path and route ``"cm"`` (``stats_batch``:
PDWs bit for bit those of the per-slot kernel), event prediction (eight 80
ms dwells at 56 Msps of a scanning beam, written by the recorder, through
``predict`` in-process, against its plain run, and through the CLI) and the
closed-loop tracker (20 dwells synthesised on the card); then the capture
containers (``ingest_views``: the sparse capture as ``.iq``, converted by
the CLI to a raw ``.npz``, a raw v5 ``.mat``, a raw v7.3 ``.mat`` and a
normalised ``.npz``, each through the main path; ``channelize`` on the card,
B9 once a file; ``waterfall_window_pngs``, B9 once a window; the
spectrogram of the wideband capture packed at bit width 12, against a
float64 STFT, timed beside its bound and the cuFFT form), before that the
sharded path (``sharded``: ``ShardedPipeline.extract_fused`` at meshes (4,
1) and (2, 2) of four shards on the one card against the single-device
step, K1 and B5 with band slices bit for bit the full kernel's rows, route
``"cm"``, wideband at (4, 1), ``pdw --shards 4`` in fresh processes, a
``--strict-halo`` refusal and two gloo ranks on the card; the sharded
PDWs are held against every pulse of an unsharded step cut to a shard's
slots), and where the machine has several cards the same path a card a
shard, in one process and in one NCCL process a card (``cards``; one line
that says it was skipped on one card; ``cards_main`` runs it alone); and
runs the CLI,
the capture commands and the views included (``convert``, ``pdw`` on
every container, ``spectrogram``, ``plot``, ``pdw --png``, ``predict
--png``, ``txrx``, ``provision --dry-run``), then the benchmark harness
(``bench``: ``sdr_channelizer_tpu_torch.bench`` in-process at M = 64 x
262144 frames, its launches counted and its pulse counts held against a
``forward_packed`` step of this run, ``--stages``, ``--planes``, the CLI's
``bench`` in a fresh process and ``bench_scaling --fused``).  A step that needs
``matplotlib``, ``h5py`` or ``cv2`` runs where the library is installed;
the line ``skipped`` names each step left out and its library.  One JSON
line per phase; any failure exits
non-zero.  The small shapes include the latch's scans across segments,
time-major (a pulse over many segments, holds over whole segments, a latch
entered active with no transfer, one channel of 2^24 - 1 samples) and
channel-major (T one frame either side of a segment, pad rows, rows that
start off a 16-byte boundary), the noise floor's select (candidates that
overflow its buffer, a sample that misses the median, NaNs, subnormals),
the pulse statistics on crafted runs (every length class and its
boundaries, constant runs and ties, +-0, +-inf, subnormals and NaNs of both
signs, runs cut at T and windows past it; B10's list of live tiles built on
the card), the flip in both load variants (M % 4 == 0 or not, views off a
16-byte boundary) and its fused one-channel form on crafted samples (at the
saturation level, phase steps of +-180 and +-360, +-0, +-inf, NaN) and the
channelizer body with T on tile boundaries, where the look-ahead frame is
taken.  Every route, wideband extraction and ``predict`` take their
noise floor with the select kernel, and its launches are counted on each.
``--profile`` adds phases that print the device time of a step by kernel
name (and the statistics kernels' share of it) and where a streamed
block's time goes.  There is no CPU path:
without a CUDA device the script exits at once with code 2 and prints no
result.

The last line of the standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

M_MAIN = 64
FRAMES_MAIN = 262144
BLOCK_FRAMES = 65536          # the streamed block (the CLI's default)
HALO_FRAMES = 1024            # its look-ahead: max_pulse_samples
STREAM_FILES = 4              # files of M_MAIN * FRAMES_MAIN samples each
WIDE_SAMPLES = 16_000_000     # the wideband capture: 0.286 s at 56 Msps
WIDE_LONG_SAMPLES = 1 << 25   # past 2^24: the blocked wideband route
WIDE_FS = 56e6
BIT_WIDTH = 12
FS_MAIN = M_MAIN * 1e6        # the main captures' rate: 1 MHz a band
DEVICE = "cuda"
# event prediction and tracking: 80 ms dwells at 56 Msps, the scanning beam
# of tools/tpu_tracker_drive.py:71-83 (10 us pulses every 5 ms, scan period
# 0.5 s, phase 0.1 s, 2000 dB/s^2, noise -55 dB) and its dense scene (:84-92)
EVENT_FS = 56e6
DWELL_SEC = 0.08
PREDICT_FILES = 8
PREDICT_WINDOW = 65536        # predict's --max-pulse-samples default
TRACK_DWELLS = 20
SCAN = dict(tone_offset_hz=5e6, pulse_width_sec=10e-6, pri_sec=5e-3,
            gain_db=60.0, rel_amplitude=0.9, noise_db=-55.0,
            scan_period_sec=0.5, scan_phase_sec=0.1,
            scan_curvature_db_per_s2=2000.0)
DENSE_SCENE = dict(SCAN, pri_sec=0.5e-3, pulse_width_sec=2e-6)
EVENT_MAG_RTOL = 2e-5   # float32 prefix sums in another order
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # H100 SXM, dense TF32 on the tensor cores

# tolerances (the JAX package's own bars)
MAG_TOL = 1e-5          # rtol = atol; the DFT sums in another order
DPH_TOL_DEG = 0.05      # modulo 360; plus the angle MAG_TOL subtends at |y|
SAT_HOVER = 1e-5        # |Re| or |Im| this close to the level may flip
SNR_TOL_DB = 1e-3
FREQ_TOL_HZ = 50.0
SPEC_TOL = 1e-5         # of the mesh's largest power (float32 products)
DENSE_COUNT_BAND = 0.02  # kernels' vs plain versions' pulse count


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------- captures

def make_capture(n: int, bands: int, sparse: bool) -> np.ndarray:
    """The benchmark captures of the JAX package: noise plus two pulsed
    tones.  Sparse: bin-centred tones 24 dB over the channel noise floor
    (the detector recovers exactly the real pulses).  Dense: full-scale
    tones in the transition band, so every channel catches edge clicks and
    threshold-hovering leakage (tens of thousands of 1-2 sample pulses)."""
    rng = np.random.default_rng(0)
    fs = bands * 1e6
    t = np.arange(n)
    iq = (0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    amp, trains = pulse_trains(sparse)
    for k, (f0, pw, pri) in enumerate(trains):
        tone = (amp * np.exp(2j * np.pi * f0 / fs * t)).astype(np.complex64)
        pw_n, pri_n = int(pw * fs), int(pri * fs)
        for s in range(137 + k * 1000, n - pw_n, pri_n):
            iq[s:s + pw_n] = tone[s:s + pw_n]
    return iq


def pulse_trains(sparse: bool):
    if sparse:
        return 0.02, [(1.0e6, 100e-6, 1e-3), (-8.0e6, 50e-6, 0.7e-3)]
    return 1.0, [(1.3e6, 100e-6, 1e-3), (-7.6e6, 50e-6, 0.7e-3)]


def quantize(cap: np.ndarray, bit_width: int = BIT_WIDTH) -> np.ndarray:
    """complex64 in [-1, 1) -> interleaved integer (I, Q) pairs."""
    full = 1 << (bit_width - 1)
    dt = np.int8 if bit_width <= 8 else np.int16
    return np.clip(np.round(np.stack([cap.real, cap.imag], -1) * full),
                   -full, full - 1).astype(dt)


def small_capture(m: int, frames: int, bit_width: int, seed: int):
    """A short capture with pulses, a clipped segment and a pulse left open
    at the end."""
    rng = np.random.default_rng(seed)
    n = m * frames + m // 2  # a ragged tail the channelizer must drop
    t = np.arange(n)
    iq = (0.004 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = (0.5 * np.exp(2j * np.pi * (1.3 / m) * t)).astype(np.complex64)
    for s, w in ((5 * m, 3 * m), (40 * m, 90 * m), (200 * m, 1 * m),
                 (260 * m, 2 * m), (300 * m, 300 * m)):
        iq[s:s + w] = tone[s:s + w]
    iq[-30 * m:] = tone[-30 * m:]          # open at the end
    iq[150 * m:150 * m + 5 * m] = 1.0 + 1.0j  # clips
    return quantize(iq, bit_width)


def pack(samples: np.ndarray) -> np.ndarray:
    return samples.view(np.int32 if samples.dtype == np.int16 else np.int16
                        ).ravel()


# ------------------------------------------------------------------ helpers

def same(a, b) -> bool:
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs(a, b) -> float:
    import torch

    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` runs of one call's time by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, reps: int = 50) -> float:
    """One call's device time: the call captured as a CUDA graph, replayed
    ``reps`` times between two CUDA events, without the host's launch
    overhead that ``time_ms`` includes."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def kernel_row(name, source, replaces, err, exact, ms, plain_ms, library_ms,
               n_bytes, n_flop, n_flop_tc=0, **extra) -> dict:
    """One entry of the ``kernels`` line; the bound from the bytes the
    function must move and the operations it does on these inputs:
    ``n_flop`` at the float32 rate of the CUDA cores, ``n_flop_tc`` at the
    dense TF32 rate of the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = (n_flop / FP32_FLOP_PER_S + n_flop_tc / TF32_FLOP_PER_S) * 1e3
    return {
        "name": name, "route": "cuda",
        "source": f"sdr_channelizer_tpu_torch/ops/cuda/csrc/{source}",
        "replaces": f"sdr_channelizer_tpu/ops/pallas/{replaces}",
        "launches": None, "max_abs_err": err, "exact": exact,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_flop),
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
        "library_ms": library_ms, **extra}


def flip_library(mag, ph, sat):
    """The flip as library calls: three ``.T.contiguous()`` and the eager
    wrapped difference (B8's yardstick)."""
    import torch

    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)
    d = torch.cat([d, d.new_zeros((1, ph.shape[1]))])
    return (mag.T.contiguous(), d.T.contiguous(),
            sat.to(torch.float32).T.contiguous())


def wideband_library(x, level: float):
    """The one-channel streams as library calls: the eager prep, then
    ``flip_library`` (the fused form's yardstick)."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod

    mag, ph, sat = pdwmod._prep_streams(x, level)
    return mag, *flip_library(mag[:, None], ph[:, None], sat[:, None])[1:]


def dft_ops(m: int, p: int, t_len: int) -> dict:
    """The channelizer's operations for ``kernel_row``: the FIR on the CUDA
    cores, the DFT as three TF32 products of the split on the tensor cores;
    and the bound of the first form, all of it at the float32 rate."""
    fir, dft = t_len * 4 * p * m, t_len * 8 * m * m
    return {"n_flop": fir, "n_flop_tc": 3 * dft,
            "bound_fp32_ms": (fir + dft) / FP32_FLOP_PER_S * 1e3}


def n_bytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def off_boundary(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary:
    the flip and the fused form take their 4-byte (8-byte pair) loads on
    it."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def device_times(fn, steps: int) -> list:
    """Device time by kernel name (memsets included) over ``steps`` calls of
    ``fn``, from ``torch.profiler``: rows of ``kernel``, ``calls_per_step``,
    ``ms_per_step``, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        is_kernel = getattr(ev, "device_type", None) is not None and \
            "cuda" in str(ev.device_type).lower()
        if is_kernel and dev_us > 0:
            rows.append({"kernel": ev.key[:80], "calls_per_step":
                         ev.count / steps,
                         "ms_per_step": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["ms_per_step"])
    return rows


# the statistics rows' calls, by row name, kept with ``--profile`` only
# (they hold their inputs, which would raise the later phases' peak memory)
STATS_CALLS = {}


def stats_device_ms(name: str, fn) -> float:
    """``device_ms`` of a statistics row's call; with ``--profile`` the call
    is kept, and that phase times it alone."""
    if "--profile" in sys.argv[1:]:
        STATS_CALLS[name] = fn
    return device_ms(fn)


def window_sort_ms(mag, dph, calls, t_len: int):
    """``library_ms`` of the pulse statistics: ``torch.sort`` along the
    window of the live slots' windows of both streams, padded with +inf, one
    sort a call; the windows are gathered outside the timer.  ``calls``:
    ``(toa, te, rows, window)`` of each call.  None where no slot is live."""
    import torch

    mats = []
    for toa, te, rows, w in calls:
        toa, te, rows = (x.reshape(-1).to(torch.int64) for x in (toa, te, rows))
        live = (toa >= 0) & (toa < t_len)
        if not bool(live.any()):
            continue
        toa, te, rows = toa[live], te[live], rows[live]
        n = torch.minimum(toa + torch.clamp(te - toa + 1, max=w),
                          torch.full_like(toa, t_len)) - toa
        pos = torch.arange(max(int(n.max()), 1), device=toa.device)
        flat = rows[:, None] * mag.stride(0) + (toa[:, None] + pos).clamp(
            max=mag.shape[1] - 1)
        mat = torch.cat([mag.reshape(-1)[flat], dph.reshape(-1)[flat]])
        mask = torch.cat([pos < n[:, None], pos < n[:, None] - 1])
        mats.append(torch.where(mask, mat, torch.full_like(mat, float("inf"))))
    if not mats:
        return None
    return time_ms(lambda: [torch.sort(x, dim=1) for x in mats])


def band_parts(m: int, band):
    """``w_parts`` of the band slice ``band = (c0, n)`` of the shift-folded
    DFT matrix, or None for the whole matrix."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import dft_matrix

    if band is None:
        return None
    w = dft_matrix(m)[:, band[0]:band[0] + band[1]]
    return (np.ascontiguousarray(w.real, np.float32),
            np.ascontiguousarray(w.imag, np.float32))


def band_cols(band):
    return slice(None) if band is None else slice(band[0], band[0] + band[1])


def compare_flat(xq, taps, bit_width, sat_level, got, where: str,
                 history=None, band=None) -> dict:
    """B5 against its plain version: magnitude at MAG_TOL, the phase at
    DPH_TOL_DEG (modulo 360) where |y| > 0.01, the mask equal but for samples
    whose |Re| or |Im| lies within SAT_HOVER of the level.  ``band``: the
    ``(c0, n)`` band slice both were given."""
    import torch

    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    mag, ph, sat = got
    pm, pp, ps = ck.channelize_streams_packed_plain(
        xq, taps, bit_width, sat_level, history=history,
        w_parts=band_parts(taps.shape[1], band))
    check(mag.shape == pm.shape == ph.shape == sat.shape,
          f"{where}: stream shapes {tuple(mag.shape)} vs {tuple(pm.shape)}")
    check(bool(torch.isfinite(mag).all() and torch.isfinite(ph).all()),
          f"{where}: non-finite stream values")
    check(torch.allclose(mag, pm, rtol=MAG_TOL, atol=MAG_TOL),
          f"{where}: mag off by {max_abs(mag, pm):.3g}")
    dd = ((ph - pp + 180.0) % 360.0 - 180.0).abs()
    ph_err = float((dd * (pm > 1e-2)).max())
    check(ph_err <= DPH_TOL_DEG,
          f"{where}: phase off by {ph_err:.3g} deg where |y| > 0.01")
    check(bool(((sat == 0) | (sat == 1)).all()), f"{where}: sat is no mask")
    yr, yi = ck.channelize_planes_plain(xq, taps, bit_width, history=history)
    cols = band_cols(band)
    hover = (((yr[:, cols].abs() - sat_level).abs() <= SAT_HOVER)
             | ((yi[:, cols].abs() - sat_level).abs() <= SAT_HOVER))
    check(bool(((sat == ps) | hover).all()),
          f"{where}: mask differs beyond the hovering samples")
    return {"mag_err": max_abs(mag, pm), "phase_err_deg": ph_err,
            "mask_diff": int((sat != ps).sum()), "hovering": int(hover.sum())}


def compare_streams(xq, taps, bit_width, sat_level, got, where: str,
                    history=None, band=None) -> dict:
    """K1, or its cm form when ``got`` has four streams, against its plain
    version: magnitude and phase difference at the stated tolerances; the
    saturation exactly (as a count), but for samples whose |Re| or |Im| lies
    within SAT_HOVER of the level, which may flip.  ``band``: the ``(c0,
    n)`` band slice K1 and its plain version were given."""
    import torch

    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    if len(got) == 4:
        mag_tm, mag, dph, sat = got
        p_tm, pm, pd, p_sat = ck.channelize_streams_packed_cm_plain(
            xq, taps, bit_width, sat_level, history=history)
        check(bool(((sat == 0) | (sat == 1)).all()),
              f"{where}: sat_cm is not a 0/1 mask")
        check(same(mag_tm, mag.T) and same(p_tm, pm.T),
              f"{where}: time-major |y| is not the flip of mag_cm")
        satcs, ps = torch.cumsum(sat, dim=1), torch.cumsum(p_sat, dim=1)
    else:
        mag, dph, satcs = got
        pm, pd, ps = ck.channelize_streams_packed_cm2_plain(
            xq, taps, bit_width, sat_level, history=history,
            w_parts=band_parts(taps.shape[1], band))
    check(mag.shape == pm.shape == dph.shape == satcs.shape,
          f"{where}: stream shapes {tuple(mag.shape)} vs {tuple(pm.shape)}")
    check(bool(torch.isfinite(mag).all() and torch.isfinite(dph).all()),
          f"{where}: non-finite stream values")
    check(torch.allclose(mag, pm, rtol=MAG_TOL, atol=MAG_TOL),
          f"{where}: mag_cm off by {max_abs(mag, pm):.3g}")
    # the planes agree to MAG_TOL, so a phase may differ by the angle that
    # MAG_TOL subtends at the sample's magnitude; dph has two samples
    dd = ((dph - pd + 180.0) % 360.0 - 180.0).abs()
    nxt = torch.roll(pm, -1, dims=1)
    slack = torch.rad2deg(MAG_TOL / pm.clamp(min=1e-30)) \
        + torch.rad2deg(MAG_TOL / nxt.clamp(min=1e-30))
    loud = (pm > 1e-4) & (nxt > 1e-4)
    check(bool(((dd <= DPH_TOL_DEG + slack) | ~loud).all()),
          f"{where}: dph_cm off by {float((dd * loud).max()):.3g} deg")
    strong = (pm > 1e-2) & (nxt > 1e-2)
    dph_err = float((dd * strong).max())
    check(dph_err <= DPH_TOL_DEG, f"{where}: dph_cm off by {dph_err:.3g} deg "
                                  f"where |y| > 0.01")
    check(bool((dph[:, -1] == 0).all()), f"{where}: last dph column not zero")
    yr, yi = ck.channelize_planes_plain(xq, taps, bit_width,
                                        history=history)
    cols = band_cols(band)
    hover = (((yr[:, cols].abs() - sat_level).abs() <= SAT_HOVER)
             | ((yi[:, cols].abs() - sat_level).abs() <= SAT_HOVER)).T
    allowed = torch.cumsum(hover.to(torch.float32), dim=1)
    sat_err = (satcs - ps).abs()
    check(bool((sat_err <= allowed).all()),
          f"{where}: satcs_cm off by {float(sat_err.max())} beyond the "
          f"hovering samples")
    return {"mag_err": max_abs(mag, pm), "dph_err_deg": dph_err,
            "satcs_err": float(sat_err.max()),
            "hovering": int(hover.sum())}


def slot_grids(packed, m: int, p_slots: int, t_len: int):
    """Edge index grids (toa, te) from the latch counts, as the main path
    builds them."""
    import torch

    from sdr_channelizer_tpu_torch.ops.rank_find import find_ranks_cm

    r = packed.shape[0] // 2
    ranks = torch.arange(1, p_slots + 1, dtype=torch.float32,
                         device=packed.device).expand(2 * r, p_slots)
    idx = find_ranks_cm(packed, ranks, t_len)
    return idx[:m].contiguous(), idx[r:r + m].contiguous()


# ------------------------------------------------------------------- phases

def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and \
        smi.stdout.strip() else "nvidia-smi unavailable"
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card)
    return card


def phase_build():
    from sdr_channelizer_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         sources=[f"sdr_channelizer_tpu_torch/ops/cuda/csrc/{n}.cu"
                  for n in _build.KERNEL_SOURCES])


def kernels_small():
    """Every kernel against its plain version at small and awkward shapes."""
    import torch

    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    cases = []
    for m, frames, bw in ((8, 1003, 12), (20, 777, 12), (56, 650, 8),
                          (64, 2049, 12), (64, 901, 8), (12, 4100, 16),
                          (560, 650, 12)):
        where = f"M={m} T={frames} bw={bw}"
        taps = Channelizer.create(m).taps_rev
        xq = torch.as_tensor(pack(small_capture(m, frames, bw, seed=m + bw)),
                             device=dev)
        got = k.channelize_streams_packed_cm2(xq, taps, bw, 0.9999)
        torch.cuda.synchronize()
        res = compare_streams(xq, taps, bw, 0.9999, got, "K1 " + where)
        check(got[2].max() > 0, f"K1 {where}: the clipped segment left no "
                                f"saturation count")
        mag, dph, _ = got
        # other tile lengths (a tile and its look-ahead frame make a
        # multiple of 16 rows), so the tiling itself is exercised; at M =
        # 560 only tiles of 15 frames fit, the default
        for ft in (15, 63) if m <= 64 else ():
            alt = k.channelize_streams_packed_cm2(xq, taps, bw, 0.9999,
                                                  tile_frames=ft)
            check(all(same(a, b) for a, b in zip(alt, got)),
                  f"K1 {where}: result depends on the tile length")

        # B6, the cm form: against its plain version, and the same bits as
        # K1 (one kernel body); then both forms with a history
        cm = k.channelize_streams_packed_cm(xq, taps, bw, 0.9999)
        torch.cuda.synchronize()
        compare_streams(xq, taps, bw, 0.9999, cm, "B6 " + where)
        check(same(cm[1], mag) and same(cm[2], dph)
              and same(torch.cumsum(cm[3], dim=1), got[2]),
              f"B6 {where}: streams are not K1's bits")
        p_taps = taps.shape[0]
        for cut in (frames // 2, p_taps - 4):
            # frames [cut, frames) with the packed frames before them: a
            # full history, and one padded on the left with zeros
            head = xq[max(cut - (p_taps - 1), 0) * m: cut * m]
            hist = torch.cat([head.new_zeros((p_taps - 1) * m - head.numel()),
                              head])
            tail = xq[cut * m: frames * m]
            for fn, whole in ((k.channelize_streams_packed_cm2, got),
                              (k.channelize_streams_packed_cm, cm)):
                part = fn(tail, taps, bw, 0.9999, history=hist)
                want = [w[cut:] if w.shape[0] == frames else w[:, cut:]
                        for w in whole]
                if len(whole) == 3:  # the count restarts at the cut
                    want[2] = want[2] - (whole[2][:, cut - 1:cut])
                check(all(same(a, b) for a, b in zip(part, want)),
                      f"{fn.__name__} {where}: a block with history from "
                      f"frame {cut} is not the tail of the whole")
            compare_streams(tail, taps, bw, 0.9999, part,
                            f"B6 {where} history at {cut}", history=hist)
        mag_tm, _, _, sat_cm = cm

        # K2: even and odd t_len, pad columns present, duplicates
        magq = torch.round(mag * 64) / 64  # many equal values at the median
        for src in (mag, magq):
            for t_len in (frames, frames - 1, 1, 2):
                a = k.noise_floor_cm(src, t_len)
                b = k.noise_floor_cm_plain(src, t_len)
                check(same(a, b), f"K2 {where} t_len={t_len}: "
                                  f"off by {max_abs(a, b):.3g}")
        nf = k.noise_floor_cm(mag, frames)

        # K3: plain thresholds; entry active; a threshold met exactly
        lead = nf * 10.0 ** 1.5
        entry = (torch.arange(m, device=dev) % 2).to(torch.float32)
        exact = mag[:, frames // 3].clone()  # lead == trail == a sample
        for th_l, th_t, ent in ((lead, lead, None), (lead, nf * 2.0, entry),
                                (exact, exact, None), (exact, exact, entry)):
            a = k.latch_cumsums_cm(mag, th_l, th_t, m, ent)
            b = k.latch_cumsums_cm_plain(mag, th_l, th_t, m, ent)
            check(same(a, b), f"K3 {where}: off by {max_abs(a, b):.3g}")
            # B7: the same latch from the time-major magnitude
            c = k.latch_cumsums(mag_tm, th_l, th_t, ent)
            d = k.latch_cumsums_plain(mag_tm, th_l, th_t, ent)
            check(same(c, d), f"B7 {where}: off by {max_abs(c, d):.3g}")
            check(same(c, a), f"B7 {where}: differs from K3 on the flip")
        packed = k.latch_cumsums_cm(mag, lead, lead, m)
        check(packed[:m, -1].sum() > 0, f"K3 {where}: no pulse detected")
        # a threshold under the last frame: every channel ends inside a
        # pulse, which B7 leaves without a trailing edge (no pad columns),
        # with and without an entry state
        th_open = 0.5 * mag[:, -1]
        for ent in (None, entry):
            c = k.latch_cumsums(mag_tm, th_open, th_open, ent)
            opens = c[:m, -1] + (0 if ent is None else ent) - c[m:, -1]
            check(bool((opens == 1).all()),
                  f"B7 {where}: a pulse open at the end got a trailing edge")

        # K4: the slots the latch found, plus crafted ones
        toa, te = slot_grids(packed, m, 64, frames)
        toa[:, -1] = frames - 3     # touches t_len, capped by it
        te[:, -1] = frames
        toa[:, -2] = 7              # one-sample pulse: empty phase range
        te[:, -2] = 7
        toa[:, -3] = 11             # longer than any window here
        te[:, -3] = frames - 1
        toa[:, -4] = frames         # dead
        first = sat_cm.argmax(dim=1).to(torch.int32)  # first saturated frame
        inside = sat_cm.any(dim=1) & (first >= 1)
        toa[:, -5] = first - 1      # that frame alone inside the pulse
        te[:, -5] = first + 1
        toa[:, -6] = first          # that frame on the leading edge
        te[:, -6] = first + 1
        perm = torch.randperm(toa.numel(), device=dev,
                              generator=torch.Generator(dev).manual_seed(m))
        chan = (perm // toa.shape[1]).to(torch.int32)
        toa_f, te_f = toa.reshape(-1)[perm], te.reshape(-1)[perm]
        for window in (128, 256, 1000):
            a = k.pulse_stats(mag, dph, toa, te, window, frames)
            b = k.pulse_stats_plain(mag, dph, toa, te, window, frames)
            check(same(a[0], b[0]) and same(a[1], b[1]),
                  f"K4 {where} window={window}: off by "
                  f"{max_abs(a[0], b[0]):.3g} / {max_abs(a[1], b[1]):.3g}")
            # with the saturation mask, and as a shuffled flat list
            a3 = k.pulse_stats(mag, dph, toa, te, window, frames, sat_cm)
            b3 = k.pulse_stats_plain(mag, dph, toa, te, window, frames,
                                     sat_cm)
            check(all(same(x, y) for x, y in zip(a3, b3)) and len(a3) == 3
                  and same(a3[0], a[0]) and same(a3[1], a[1]),
                  f"K4 sat_cm {where} window={window}: differs from plain")
            check(same(a3[2][:, -5], inside.to(torch.float32))
                  and bool(inside.any()) and not bool(a3[2][:, -6].any()),
                  f"K4 sat_cm {where} window={window}: flag not strictly "
                  f"inside the pulse")
            ad = k.pulse_stats_dense(mag, dph, sat_cm, toa_f, te_f, chan,
                                     window, frames)
            bd = k.pulse_stats_dense_plain(mag, dph, sat_cm, toa_f, te_f,
                                           chan, window, frames)
            check(all(same(x, y) for x, y in zip(ad, bd))
                  and all(same(x, y.reshape(-1)[perm])
                          for x, y in zip(ad, a3)),
                  f"K4 dense {where} window={window}: differs from plain")
            # B10: the same slots a batch of tiles at a time, K4's bits
            for bt in (2, 8):
                ab = k.pulse_stats(mag, dph, toa, te, window, frames, sat_cm,
                                   batch_tiles=bt)
                adb = k.pulse_stats_dense(mag, dph, sat_cm, toa_f, te_f, chan,
                                          window, frames, batch_tiles=bt)
                check(all(same(x, y) for x, y in zip(ab, a3))
                      and all(same(x, y) for x, y in zip(adb, ad)),
                      f"B10 {where} window={window} batch_tiles={bt}: "
                      f"differs from K4")
        torch.cuda.synchronize()
        cases.append({"case": where, **res})
    return cases


def stats_nan_high(mag, dph, sat, toa, te, rows, window: int, t_len: int):
    """The statistics as a sort gives them with NaNs above every number,
    the padding included: the plain version's gather with NaN, not +inf, in
    the unused places of a window.  It differs from the plain version only
    where NaNs reach the middle ranks of a run (ROADMAP C)."""
    import torch

    toa, te, rows = (x.reshape(-1).to(torch.int64) for x in (toa, te, rows))
    live = (toa >= 0) & (toa < t_len)
    plen = torch.clamp(te - toa + 1, max=window)
    n_m = (torch.minimum(toa + plen, torch.full_like(toa, t_len)) - toa)
    n_m = torch.where(live, n_m.clamp(min=0), torch.zeros_like(n_m))
    n_d = (torch.minimum(toa + plen - 1, torch.full_like(toa, t_len)) - toa)
    n_d = torch.where(live, n_d.clamp(min=0), torch.zeros_like(n_d))
    pos = torch.arange(max(int(n_m.max()), 1), device=toa.device)
    flat = rows[:, None] * mag.stride(0) + (toa.clamp(min=0)[:, None]
                                            + pos).clamp(max=mag.shape[1] - 1)

    def med(stream, n):
        # +NaN in every unused place and for every NaN (torch.sort on the
        # card puts a NaN with its sign bit set lowest where it sorts by
        # radix)
        x = stream.reshape(-1)[flat]
        x = torch.where((pos < n[:, None]) & ~torch.isnan(x), x,
                        torch.full_like(x, float("nan")))
        x = torch.sort(x, dim=1).values
        lo = x.gather(1, ((n - 1) // 2).clamp(min=0)[:, None])[:, 0]
        hi = x.gather(1, (n // 2)[:, None].clamp(max=x.shape[1] - 1))[:, 0]
        out = torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, float(
            "nan")))
        return torch.where(live, out, torch.zeros_like(out))

    outs = [med(mag, n_m), med(dph, n_d)]
    if sat is not None:
        x = sat.reshape(-1)[flat]
        outs.append((((x > 0.5) & (pos >= 1) & (pos < n_d[:, None])).any(1)
                     & live).to(torch.float32))
    return outs


def kernels_small_pulse_stats():
    """K4 (grid and flat list, with and without the mask) and B10 on crafted
    runs, bit for bit against the plain versions: every length class and its
    boundaries (0, 1 and 2 samples, 32 / 33, 128 / 129, the select block's
    stretch and one past it, long runs whose middle 12-bit bin fits or
    overflows shared memory), constant runs and ties across the middle,
    +-0.0, subnormals, +-inf and NaNs of both signs, runs cut at t_len, and
    windows up to longer than T.  Where NaNs reach the middle ranks of a run
    the plain version's +inf padding sorts below them (ROADMAP C); every
    slot is held to ``stats_nan_high``, and to the plain version wherever
    the two agree."""
    import torch

    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(77)
    m, t_arr, t_len, p_slots = 6, 40_000, 39_990, 64
    bits = {"nan": 0x7fc00000, "-nan": 0xffc00000, "nan2": 0x7f800001,
            "-nan2": 0xff812345}
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                         1.2e-39, -3.4e-40] + [np.uint32(b).view(np.float32)
                                               for b in bits.values()],
                        dtype=np.float32)

    def stream(seed):
        g = np.random.default_rng(seed)
        x = np.empty((m, t_arr), np.float32)
        x[0] = g.standard_normal(t_arr)
        sprinkle = g.random(t_arr) < 0.05
        x[0][sprinkle] = g.choice(specials, int(sprinkle.sum()))
        x[1] = np.round(g.standard_normal(t_arr) * 8) / 8      # ties
        x[2] = 0.5                                              # constant
        x[2, 20_000:] = g.choice(np.array([0.0, -0.0], np.float32),
                                 t_arr - 20_000)
        x[3] = 0.5 + 1e-4 * g.standard_normal(t_arr)           # one bin
        x[4] = g.standard_normal(t_arr)
        heavy = g.random(t_arr) < 0.6                           # NaN-heavy
        x[4][heavy] = g.choice(specials[-4:], int(heavy.sum()))
        x[5] = g.choice(specials[:8], t_arr)                    # zeros, inf,
        return x                                                # subnormals

    mag = torch.as_tensor(stream(1), device=dev)
    dph = torch.as_tensor(stream(2), device=dev)
    sat = torch.as_tensor((rng.random((m, t_arr)) < 0.01).astype(np.float32),
                          device=dev)
    lengths = [0, 1, 2, 3, 31, 32, 33, 34, 127, 128, 129, 130, 1000,
               psk.BLOCK_KEYS - 1, psk.BLOCK_KEYS, psk.BLOCK_KEYS + 1,
               psk.BLOCK_KEYS + 2, 20_000, 33_000]
    toa = np.full((m, p_slots), t_len, np.int32)
    te = np.full((m, p_slots), t_len, np.int32)
    for c in range(m):
        for j, n in enumerate(lengths):
            toa[c, j] = rng.integers(0, t_len - n)
            te[c, j] = toa[c, j] + n - 1
        tail = len(lengths)
        toa[c, tail:tail + 4] = [t_len - 50, t_len - 1, t_len - 3, -1]
        te[c, tail:tail + 4] = [t_len + 449, t_len + 5, t_arr + 100, 10]
        toa[c, tail + 4] = t_len                       # dead: at t_len
        for j in range(tail + 5, tail + 25):           # random, any class
            n = int(rng.choice([2, 5, 17, 40, 100, 140, 600, 3000]))
            toa[c, j] = rng.integers(0, t_len - 1)
            te[c, j] = toa[c, j] + n - 1
    toa, te = (torch.as_tensor(x, device=dev) for x in (toa, te))
    rows = torch.arange(m, device=dev).repeat_interleave(p_slots)
    perm = torch.randperm(m * p_slots, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    chan = rows[perm].to(torch.int32)
    toa_f, te_f = toa.reshape(-1)[perm], te.reshape(-1)[perm]

    def elementwise_same(a, b):
        return (a == b) | (torch.isnan(a) & torch.isnan(b))

    out = {"slots": m * p_slots, "windows": [], "nan_middle_slots": 0}
    for window in (128, 1024, psk.BLOCK_KEYS, 65536):
        ref = stats_nan_high(mag, dph, sat, toa, te, rows, window, t_len)
        plain = k.pulse_stats_plain(mag, dph, toa, te, window, t_len, sat)
        got = k.pulse_stats(mag, dph, toa, te, window, t_len, sat)
        got2 = k.pulse_stats(mag, dph, toa, te, window, t_len)
        dense = k.pulse_stats_dense(mag, dph, sat, toa_f, te_f, chan, window,
                                    t_len)
        dense2 = k.pulse_stats_dense(mag, dph, None, toa_f, te_f, chan,
                                     window, t_len)
        forms = [("K4", got), ("K4 no mask", got2),
                 ("K4 dense", [x[torch.argsort(perm)].reshape(m, p_slots)
                               for x in dense]),
                 ("K4 dense no mask", [x[torch.argsort(perm)].reshape(
                     m, p_slots) for x in dense2])]
        if psk.batched_tiles(8, window, m * p_slots) > 1:
            forms.append(("B10", k.pulse_stats(mag, dph, toa, te, window,
                                               t_len, sat, batch_tiles=8)))
            forms.append(("B10 dense", [
                x[torch.argsort(perm)].reshape(m, p_slots)
                for x in k.pulse_stats_dense(mag, dph, sat, toa_f, te_f, chan,
                                             window, t_len, batch_tiles=8)]))
        torch.cuda.synchronize()
        agree = [elementwise_same(p.reshape(-1), r) for p, r in
                 zip(plain, ref)]
        for name, outs in forms:
            for i, (g, r, p, ag) in enumerate(zip(outs, ref, plain, agree)):
                g = g.reshape(-1)
                bad = torch.nonzero(~elementwise_same(g, r))[:4, 0].tolist()
                check(not bad,
                      f"{name} window={window} output {i}: differs from a "
                      f"sort with NaNs high at (slot, toa, te, got, want) "
                      f"{[(j, int(toa.reshape(-1)[j]), int(te.reshape(-1)[j]), float(g[j]), float(r[j])) for j in bad]}")
                check(bool(elementwise_same(g, p.reshape(-1))[ag].all()),
                      f"{name} window={window} output {i}: differs from the "
                      f"plain version")
            check(all(same(g, h) for g, h in zip(outs, got)),
                  f"{name} window={window}: differs from K4")
        out["windows"].append(window)
        out["nan_middle_slots"] += int(sum((~a).sum() for a in agree))
    check(out["nan_middle_slots"] > 0,
          "K4 crafted runs: no run has NaNs in its middle ranks")
    # B10's list of live tiles, built on the card, against its plain version
    lists = 0
    for seed in range(3):
        g = np.random.default_rng(seed)
        n_s = 128 * 11 + 37
        tl = np.full(n_s, 1000, np.int32)
        tl[5] = -3
        for t in np.flatnonzero(g.random(12) < 0.4):
            tl[128 * t + g.integers(0, min(128, n_s - 128 * t))] = \
                g.integers(0, 1000)
        for nt in (2, 3, 8):
            ids, n_l, n_b = psk._live_tiles(torch.as_tensor(tl, device=dev),
                                            1000, nt)
            ids_c, n_c, n_bc = psk._live_tiles(torch.as_tensor(tl), 1000, nt)
            n_l = int(n_l)
            check(n_l == int(n_c) and n_b == n_bc
                  and ids.numel() == ids_c.numel()
                  and torch.equal(ids[:n_l].cpu(), ids_c[:n_l])
                  and bool((ids[n_l:] == -1).all()),
                  f"B10 live tiles seed={seed} nt={nt}: the card's list "
                  f"differs from the plain one")
            lists += 1
    out["live_tile_lists"] = lists
    return out


def _nf_fits(mag, t_len: int) -> int:
    """Rows of ``mag`` whose keys under the median's top 12 bits fit K2's
    candidate buffer: the rows whose last digits are not taken from the row
    itself."""
    import torch

    from sdr_channelizer_tpu_torch.ops.cuda import nf_kernel
    from sdr_channelizer_tpu_torch.ops.medians import sortable_u32

    lo = torch.sort(mag[:, :t_len], dim=1).values[:, (t_len - 1) // 2]
    top = sortable_u32(lo) >> 20
    n_in = (sortable_u32(mag[:, :t_len]) >> 20 == top[:, None]).sum(dim=1)
    cap = nf_kernel._library().sdr_noise_floor_cap(t_len)
    return int((n_in <= cap).sum())


def kernels_small_latch_nf():
    """K3's segment scan and K2's select at the shapes where they can go
    wrong: K3 with T one frame short of, on and past a segment (4096
    frames) and three segments and one, one row, pad rows (m_real < R), rows
    whose start is not 16 bytes aligned; K2 with odd and even lengths,
    candidates that overflow the buffer (quantized, constant-heavy rows), a
    sample that misses the median, hi in the 12-bit bin after lo's, NaNs,
    subnormals, rows far apart and a 1-D row."""
    import torch

    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(6)
    seg = 4096
    cases = []
    for r, m_real, t_len in ((16, 13, seg - 1), (16, 13, seg),
                             (16, 13, seg + 1), (16, 13, 3 * seg + 1),
                             (1, 1, 3 * seg + 1), (64, 61, seg + 3),
                             (3, 2, 5)):
        t = torch.arange(t_len, device=dev)
        mag = torch.rand((r, t_len), device=dev, generator=gen) * 0.2
        for c in range(r):   # pulses over segment boundaries
            on = ((t + 977 * c) % (1500 + 37 * c)) < 300 + 11 * c
            mag[c] = torch.where(on, mag[c] + 0.8, mag[c])
        mag[:, -7:] = 0.9            # open at T - 1
        mag[:, t_len // 2] = 0.6     # exactly on lead
        mag[:, t_len // 3] = 0.3     # exactly on trail
        if r > 2:
            mag[1] = 0.45            # holds only: no transfer at all
        lead = torch.full((m_real,), 0.6, device=dev)
        trail = torch.full((m_real,), 0.3, device=dev)
        entry = (torch.arange(m_real, device=dev) % 2).float()
        for th_t, ent in ((trail, None), (trail, entry), (lead, entry)):
            a = k.latch_cumsums_cm(mag, lead, th_t, m_real, ent)
            b = k.latch_cumsums_cm_plain(mag, lead, th_t, m_real, ent)
            check(same(a, b), f"K3 R={r} m_real={m_real} T={t_len}: off by "
                              f"{max_abs(a, b):.3g}")
        a = k.latch_cumsums_cm(mag, lead, trail, m_real, entry)
        check(bool((a[:m_real, -1] + entry - a[r:r + m_real, -1] == 1).all()),
              f"K3 R={r} T={t_len}: a pulse open at T - 1 was closed")
        cases.append({"case": f"K3 R={r} m_real={m_real} T={t_len}",
                      "exact": True, "row_16_byte_aligned": t_len % 4 == 0})
    # rows that start 4 bytes past a 16-byte boundary
    base = torch.rand((8 * 5003 + 1,), device=dev, generator=gen)
    mag = base[1:].view(8, 5003)
    lead = torch.full((8,), 0.9, device=dev)
    trail = torch.full((8,), 0.2, device=dev)
    check(same(k.latch_cumsums_cm(mag, lead, trail),
               k.latch_cumsums_cm_plain(mag, lead, trail)),
          "K3 unaligned rows: differs from plain")
    cases.append({"case": "K3 R=8 T=5003, base 4 bytes past 16",
                  "exact": True})

    def floor(x, t_len, what):
        a, b = k.noise_floor_cm(x, t_len), k.noise_floor_cm_plain(x, t_len)
        check(same(a, b), f"K2 {what} t_len={t_len}: off by "
                          f"{max_abs(a, b):.3g}")

    ray = torch.hypot(torch.randn((16, 40001), device=dev, generator=gen),
                      torch.randn((16, 40001), device=dev, generator=gen))
    quant = torch.round(ray)                    # the median's bin holds most
    heavy = torch.where(ray < 2.0, torch.full_like(ray, 1.25), ray)
    nan = ray.clone()
    nan[:, ::3] = float("nan")
    sub = ray * 1e-39                           # subnormals
    for x, what in ((ray, "noise"), (quant, "quantized"),
                    (heavy, "constant-heavy"), (nan, "NaN"),
                    (sub, "subnormal")):
        for t_len in (40001, 40000, 16385, 2, 1):
            floor(x, t_len, what)
    for x, what in ((quant, "quantized"), (heavy, "constant-heavy")):
        check(_nf_fits(x, 40000) == 0,
              f"K2 {what}: the candidates did not overflow the buffer")
    check(_nf_fits(ray, 40000) == 16, "K2 noise: candidates overflowed")
    # a sample that misses the median (the sampled runs hold tiny values):
    # the row is read again; lo and hi in neighbouring 12-bit bins of the
    # window, each holding few keys: hi is the least key of its bin
    i = torch.arange(8192, device=dev)
    sampled = (i // 128) * (40001 - 128) // 63 + i % 128
    missed = ray.clone()
    missed[:, sampled] = 1e-3
    split = torch.cat([torch.linspace(0.01, 0.99, 20000, device=dev),
                       torch.linspace(1.01, 100.0, 20001, device=dev)])
    for t_len in (40001, 40000):
        floor(missed, t_len, "sample missed")
        floor(split.expand(4, -1).contiguous(), t_len, "hi split off")
    floor(ray[:, 1:40001], 40000, "rows 4 bytes past 16")
    floor(ray[::5], 40001, "rows five rows apart")
    floor(ray.reshape(-1)[None], ray.numel(), "one 1-D row")
    cases.append({"case": "K2 R=16 T=40001: noise, quantized, "
                          "constant-heavy, NaN, subnormal; odd and even",
                  "exact": True, "overflowing": ["quantized",
                                                 "constant-heavy"]})
    return cases


def kernels_small_flip_flat_complex():
    """The flip kernel (both load variants, views off a 16-byte boundary),
    its fused one-channel form on crafted samples, the flat form and the
    complex form against their plain versions at small and awkward shapes;
    the time-major latch at fewer channels than one of its blocks owns."""
    import torch

    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel as tk

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
    cases = []

    # B8: exact, any M from 1 and any T (on both sides of its 128-frame
    # tile and of the one-channel pass's 256-sample warp span), t_len 1 and
    # 2, both mask dtypes, an infinite magnitude and a NaN phase carried
    # through.  The kernel takes 16-byte loads on fresh tensors where M % 4
    # == 0 or M = 1, 4-byte ones where M % 4 != 0 and off a 16-byte boundary
    for t_len, m in ((1, 1), (2, 1), (1, 3), (2, 3), (2500, 1), (4099, 1),
                     (255, 1), (257, 1), (1003, 3), (777, 56), (2049, 64),
                     (3001, 33), (2049, 2), (127, 6), (129, 4), (130, 65),
                     (1, 64), (4097, 560)):
        mag = torch.rand((t_len, m), device=dev, generator=gen)
        mag[t_len // 2, m // 2] = float("inf")
        ph = (torch.rand((t_len, m), device=dev, generator=gen) - 0.5) * 360.0
        ph[t_len // 3] = 180.0   # steps of exactly +-180 and +-360
        ph[t_len // 3 + 1:t_len // 3 + 2] = -180.0
        ph[(2 * t_len) // 3, m - 1] = float("nan")
        sat_b = torch.rand((t_len, m), device=dev, generator=gen) > 0.9
        for sat in (sat_b, sat_b.to(torch.float32)):
            a = k.cm_streams(mag, ph, sat)
            check(all(x.shape == (m, t_len) for x in a)
                  and all(same(x, y) for x, y in
                          zip(a, k.cm_streams_plain(mag, ph, sat))),
                  f"B8 T={t_len} M={m} {sat.dtype}: differs from plain")
            check(bool((a[1][:, -1] == 0).all()),
                  f"B8 T={t_len} M={m}: last dph column not zero")
        cases.append({"case": f"B8 T={t_len} M={m}", "exact": True,
                      "loads": "16-byte" if m % 4 == 0 or m == 1
                      else "4-byte"})
    # views into a longer buffer, at an element offset of 1 (off a 16-byte
    # boundary: the 4-byte loads) and of 4 (on one: the 16-byte loads where
    # M % 4 == 0 or M = 1); the kernel launches (the counter moves) and
    # gives the plain bits, never the plain version in its place
    for t_len, m in ((1001, 1), (1001, 3), (1001, 4), (513, 64)):
        for off in (1, 4):
            def view(x):
                return x.reshape(-1)[off:off + t_len * m].view(t_len, m)

            shape = (t_len + off, m)
            mag = view(torch.rand(shape, device=dev, generator=gen))
            ph = view((torch.rand(shape, device=dev, generator=gen) - 0.5)
                      * 360.0)
            sat_b = view(torch.rand(shape, device=dev, generator=gen) > 0.5)
            sat_f = view(torch.rand(shape, device=dev, generator=gen) > 0.5
                         ).float()
            for sat in (sat_b, view(torch.cat([
                    sat_f.reshape(-1), sat_f.new_zeros(off * m)]))):
                before = tk.launches
                a = k.cm_streams(mag, ph, sat)
                check(tk.launches == before + 1
                      and all(same(x, y) for x, y in
                              zip(a, k.cm_streams_plain(mag, ph, sat))),
                      f"B8 view +{off} M={m} {sat.dtype}: not the kernel's "
                      f"plain bits")
            cases.append({"case": f"B8 view at element {off} T={t_len} "
                                  f"M={m}", "exact": True, "launched": True})

    # the one-channel streams from the capture: bit for bit the plain chain
    # (prep_streams, then the flip's plain version) on crafted samples:
    # exactly at the saturation level and just under it, phase steps of
    # exactly +-180 and +-360, +-0 in both parts, +-inf and NaN; T of 1, 2,
    # on both sides of a warp span; as a fresh capture (16-byte loads) and
    # as a view one sample in (8 bytes off: a pair a load)
    special = torch.tensor([
        0.9999, -0.9999, 0.9999j, -0.9999j, 0.99989, 1.0, -1.0, 1.0,
        complex(-1.0, 0.0), complex(-1.0, -0.0), complex(-1.0, 0.0),
        complex(0.0, 0.0), complex(-0.0, 0.0), complex(-0.0, -0.0),
        complex(0.0, -0.0), complex(float("inf"), 0.0),
        complex(-float("inf"), 1.0), complex(0.0, -float("inf")),
        complex(float("inf"), float("inf")), complex(float("nan"), 0.0),
        complex(0.0, float("nan")), 0.5j, -0.5], dtype=torch.complex64,
        device=dev)
    for n in (1, 2, 3, 4, 5, 23, 255, 256, 257, 4095, 4096, 4097, 70001):
        x = torch.randn(n + 1, dtype=torch.complex64, device=dev,
                        generator=gen) * 0.5
        idx = torch.randint(0, len(special), (n + 1,), device=dev,
                            generator=gen)
        x = torch.where(torch.rand(n + 1, device=dev, generator=gen) < 0.3,
                        special[idx], x)
        x[:min(n, len(special))] = special[:min(n, len(special))]
        for where, xs in (("aligned", x[:n]), ("view", x[1:])):
            before = tk.launches_wideband
            got = k.wideband_streams(xs, 0.9999)
            check(tk.launches_wideband == before + 1
                  and all(same(a, b) for a, b in
                          zip(got, k.wideband_streams_plain(xs, 0.9999))),
                  f"wideband_streams T={n} {where}: differs from plain")
    cases.append({"case": "wideband_streams crafted samples, T = 1 .. 70001",
                  "exact": True, "forms": ["aligned", "view"]})

    # B7 where a block has absent channels
    for m in (1, 3, 64):
        mag = torch.rand((5003, m), device=dev, generator=gen)
        hi = torch.full((m,), 0.9, device=dev)
        lo = torch.full((m,), 0.3, device=dev)
        for ent in (None, (torch.arange(m, device=dev) % 2).float()):
            c = k.latch_cumsums(mag, hi, lo, ent)
            d = k.latch_cumsums_plain(mag, hi, lo, ent)
            check(same(c, d), f"B7 M={m}: off by {max_abs(c, d):.3g}")
        cases.append({"case": f"B7 T=5003 M={m}", "exact": True})

    # B7's scan across segments (4096 frames at M = 1, 512 else): a pulse
    # over many segments, holds over whole segments between a set and a
    # reset, thresholds met exactly on segment boundaries, a latch entered
    # active that sees no transfer at all; then M = 1 at T = 2^24 - 1
    for m, t_len in ((1, 70001), (9, 9001), (64, 6001)):
        seg = 4096 if m == 1 else 512
        t = torch.arange(t_len, device=dev)[:, None]
        base = torch.rand((t_len, m), device=dev, generator=gen) * 0.2
        span = (t >= seg // 2) & (t < seg // 2 + 5 * seg + 17)
        hold = (t >= 7 * seg + 3) & (t < t_len - 5)
        mag = torch.where(span, base + 0.8, base)
        mag = torch.where(hold, torch.full_like(mag, 0.5), mag)
        mag[7 * seg + 2] = 0.95           # a set, then holds to the end
        edges = torch.arange(seg, t_len, seg, device=dev)
        mag[edges] = 0.6                  # on the threshold: lead == trail
        mag[edges - 1] = 0.6
        hi = torch.full((m,), 0.6, device=dev)
        lo = torch.full((m,), 0.3, device=dev)
        ent = (torch.arange(m, device=dev) % 2).float()
        for th_t, e in ((lo, None), (lo, ent), (hi, ent)):
            c = k.latch_cumsums(mag, hi, th_t, e)
            d = k.latch_cumsums_plain(mag, hi, th_t, e)
            check(same(c, d), f"B7 segments M={m} T={t_len}: off by "
                              f"{max_abs(c, d):.3g}")
        quiet = torch.full((t_len, m), 0.45, device=dev)   # holds only
        c = k.latch_cumsums(quiet, hi, lo, torch.ones(m, device=dev))
        check(same(c, k.latch_cumsums_plain(quiet, hi, lo,
                                            torch.ones(m, device=dev)))
              and not bool(c.any()),
              f"B7 segments M={m}: an entered latch without a transfer")
        cases.append({"case": f"B7 segments T={t_len} M={m}", "exact": True})
    t_len = (1 << 24) - 1
    t = torch.arange(t_len, device=dev)
    mag = torch.where((t % 1_000_003) < 400_000, 0.9, 0.1)[:, None]
    mag = mag + torch.rand((t_len, 1), device=dev, generator=gen) * 0.05
    hi, lo = torch.full((1,), 0.6, device=dev), torch.full((1,), 0.3,
                                                            device=dev)
    c = k.latch_cumsums(mag, hi, lo)
    d = k.latch_cumsums_plain(mag, hi, lo)
    check(same(c, d) and int(c[0, -1]) == 17,
          f"B7 M=1 T=2^24-1: off by {max_abs(c, d):.3g}")
    del t, mag, c, d
    cases.append({"case": f"B7 T={t_len} M=1", "exact": True})

    # the channelizer body at T on tile boundaries (7440 is a multiple of
    # every tile length the wrappers choose here: 15, 31 with the look-ahead
    # frame, 16, 32 without): K1, B6, B5 against their plain versions, and
    # B5's |y| = B6's = K1's, bit for bit; at M = 64 and at M = 65
    for m in (64, 65):
        taps = Channelizer.create(m).taps_rev
        full = small_capture(m, 7442, 12, seed=m)
        for frames in (7439, 7440, 7441):
            where = f"M={m} T={frames}"
            xq = torch.as_tensor(pack(full[:m * frames]), device=dev)
            k1 = k.channelize_streams_packed_cm2(xq, taps, 12, 0.9999)
            compare_streams(xq, taps, 12, 0.9999, k1, "K1 " + where)
            cm = k.channelize_streams_packed_cm(xq, taps, 12, 0.9999)
            compare_streams(xq, taps, 12, 0.9999, cm, "B6 " + where)
            flat = k.channelize_streams_packed(xq, taps, 12, 0.9999)
            compare_flat(xq, taps, 12, 0.9999, flat, "B5 " + where)
            alt = k.channelize_streams_packed_cm2(xq, taps, 12, 0.9999,
                                                  tile_frames=15)
            check(same(cm[1], k1[0]) and same(cm[2], k1[1])
                  and same(flat[0], cm[0])
                  and all(same(a, b) for a, b in zip(alt, k1)),
                  f"body {where}: B5, B6, K1 or another tile length do not "
                  f"give the same bits")
        cases.append({"case": f"body at tile boundaries M={m}",
                      "frames": [7439, 7440, 7441],
                      "exact_across_forms": True})

    # B5 and B9, packed and planes ingests, with a history
    for m, frames, bw in ((3, 777, 12), (8, 1003, 12), (56, 650, 8),
                          (64, 2049, 12)):
        where = f"M={m} T={frames} bw={bw}"
        taps = Channelizer.create(m).taps_rev
        p_taps = taps.shape[0]
        samples = small_capture(m, frames, bw, seed=m + bw)
        xq = torch.as_tensor(pack(samples), device=dev)
        flat = k.channelize_streams_packed(xq, taps, bw, 0.9999)
        res = compare_flat(xq, taps, bw, 0.9999, flat, "B5 " + where)
        check(flat[2].sum() > 0, f"B5 {where}: the clipped segment left no "
                                 f"saturated sample")
        cm = k.channelize_streams_packed_cm(xq, taps, bw, 0.9999)
        check(same(flat[0], cm[0]) and same(flat[2], cm[3].T),
              f"B5 {where}: mag and mask are not B6's bits")
        cut = frames // 2
        hist = xq[(cut - (p_taps - 1)) * m: cut * m]
        tail = xq[cut * m: frames * m]
        part = k.channelize_streams_packed(tail, taps, bw, 0.9999,
                                           history=hist)
        check(all(same(a, b[cut:]) for a, b in zip(part, flat)),
              f"B5 {where}: a block with history is not the tail of the whole")
        compare_flat(tail, taps, bw, 0.9999, part,
                     f"B5 {where} history at {cut}", history=hist)
        # planes: the raw integers (widened to int16) and their float32
        # dequantization give the packed ingest's bits, in every form
        n = frames * m
        xr, xi = (torch.as_tensor(np.ascontiguousarray(samples[:n, j]),
                                  device=dev).to(torch.int16) for j in (0, 1))
        scale = float(2.0 ** -(bw - 1))
        fr, fi = (v.to(torch.float32) * scale for v in (xr, xi))
        k1 = k.channelize_streams_packed_cm2(xq, taps, bw, 0.9999)
        for planes, width in (((xr, xi), bw), ((fr, fi), 0)):
            for fn, want in ((k.channelize_streams, flat),
                             (k.channelize_streams_cm, cm),
                             (k.channelize_streams_cm2, k1)):
                got = fn(*planes, taps, width, 0.9999)
                check(all(same(a, b) for a, b in zip(got, want)),
                      f"{fn.__name__} {where} {planes[0].dtype}: not the "
                      f"packed ingest's bits")
        hp = tuple(v[(cut - (p_taps - 1)) * m: cut * m].contiguous()
                   for v in (fr, fi))
        tp = tuple(v[cut * m:].contiguous() for v in (fr, fi))
        part = k.channelize_streams(*tp, taps, 0, 0.9999, history=hp)
        check(all(same(a, b[cut:]) for a, b in zip(part, flat)),
              f"channelize_streams {where}: planes history")

        x = torch.as_tensor(iqpacket.to_complex(samples, bw), device=dev)
        y = k.channelize_complex(x, taps)
        yp = k.channelize_complex_plain(x, taps)
        check(y.shape == (frames, m) and y.dtype == torch.complex64
              and torch.allclose(torch.view_as_real(y), torch.view_as_real(yp),
                                 rtol=MAG_TOL, atol=MAG_TOL),
              f"B9 {where}: off by {float((y - yp).abs().max()):.3g}")
        y2 = k.channelize_complex_planes(x.real.contiguous(),
                                         x.imag.contiguous(), taps)
        check(bool((y == y2).all()), f"B9 {where}: planes differ from the "
                                     f"capture read in place")
        check(same(y.abs(), flat[0]) or torch.allclose(
            y.abs(), flat[0], rtol=MAG_TOL, atol=MAG_TOL),
            f"B9 {where}: |y| is not B5's magnitude")
        torch.cuda.synchronize()
        cases.append({"case": "B5 B9 " + where, **res,
                      "complex_err": float((y - yp).abs().max())})
    return cases


def kernels_flat_complex_main_shape(xq, samples, pipe, rows):
    """B5, B8 and B9 against their plain versions, and timed, at M = 64 x
    262144 frames on the dense capture; B7 and B8 on the streams B5 gives
    them, as the flat route does."""
    import torch

    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.medians import median

    m, t_len = M_MAIN, FRAMES_MAIN
    taps = pipe.channelizer.taps_rev
    sat_level = pipe.pdw_cfg.saturation_level
    p = taps.shape[0]
    n_w = 4 * (p * m + 4 * m * m)   # the taps and W's four split planes

    flat = k.channelize_streams_packed(xq, taps, BIT_WIDTH, sat_level)
    torch.cuda.synchronize()
    res = compare_flat(xq, taps, BIT_WIDTH, sat_level, flat, "B5 main shape")
    cm = k.channelize_streams_packed_cm(xq, taps, BIT_WIDTH, sat_level)
    check(same(flat[0], cm[0]), "B5 main shape: mag is not B6's time-major "
                                "mag bit for bit")
    del cm
    rows.append(kernel_row(
        "channelize_streams_packed", "channelizer.cu",
        "channelizer_kernel.py:602", res["mag_err"], False,
        time_ms(lambda: k.channelize_streams_packed(
            xq, taps, BIT_WIDTH, sat_level)),
        time_ms(lambda: k.channelize_streams_packed_plain(
            xq, taps, BIT_WIDTH, sat_level), reps=3, warmup=1),
        None, n_bytes=n_bytes_of(xq, *flat) + n_w, **dft_ops(m, p, t_len),
        mag_equals_b6=True, shape=f"M={m} T={t_len}", **res))

    mag, ph, sat = flat[0], flat[1], flat[2] > 0.5
    # B7 on the magnitude B5 gives it, with the flat route's thresholds
    lead, trail = pdwmod._thresholds(median(mag, dim=0), pipe.pdw_cfg)
    a = k.latch_cumsums(mag, lead, trail)
    b = k.latch_cumsums_plain(mag, lead, trail)
    check(same(a, b), f"B7 flat-route shape: off by {max_abs(a, b):.3g}")
    check(float(a[:m, -1].sum()) > 0, "B7 flat-route shape: no edge counted")
    # B7's row (the block shape) carries this shape too
    b7 = next(r for r in rows if r["name"] == "latch_cumsums")
    b7["route_shape"] = {
        "shape": f"M={m} T={t_len}",
        "ms": time_ms(lambda: k.latch_cumsums(mag, lead, trail)),
        "bound_ms": 12 * m * t_len / HBM_BYTES_PER_S * 1e3}
    del a, b, lead, trail

    # B8 with the bool mask (the row), then with B5's float mask as route
    # "flat" hands it over; each on the fresh streams (16-byte loads) and on
    # copies one element off a 16-byte boundary (4-byte loads), bit for bit
    sat_f = flat[2]
    variants = {}
    for name, mask in (("bool", sat), ("float", sat_f)):
        b = k.cm_streams_plain(mag, ph, mask)
        for loads, streams in (("16_byte", (mag, ph, mask)),
                               ("4_byte_off_boundary",
                                tuple(off_boundary(t)
                                      for t in (mag, ph, mask)))):
            a = k.cm_streams(*streams)
            check(all(same(x, y) for x, y in zip(a, b)),
                  f"B8 main shape, {name} mask, {loads} loads: differs from "
                  f"plain")
            variants[f"{name}_mask_{loads}"] = {
                "ms": time_ms(lambda: k.cm_streams(*streams)),
                "device_ms": device_ms(lambda: k.cm_streams(*streams))}
            del a, streams
        variants[f"{name}_mask_bound_ms"] = n_bytes_of(
            mag, ph, mask, *b) / HBM_BYTES_PER_S * 1e3
        del b

    rows.append(kernel_row(
        "cm_streams", "transpose.cu", "transpose_kernel.py:136", 0.0, True,
        time_ms(lambda: k.cm_streams(mag, ph, sat)),
        time_ms(lambda: k.cm_streams_plain(mag, ph, sat), reps=3, warmup=1),
        time_ms(lambda: flip_library(mag, ph, sat), reps=3, warmup=1),
        n_bytes=n_bytes_of(mag, ph, sat) + 3 * 4 * m * t_len, n_flop=0,
        device_ms=device_ms(lambda: k.cm_streams(mag, ph, sat)),
        shape=f"M={m} T={t_len}", mask="bool", variants=variants))
    del flat, mag, ph, sat, sat_f

    x = torch.as_tensor(iqpacket.to_complex(samples, BIT_WIDTH),
                        device=xq.device)
    y = k.channelize_complex(x, taps)
    yp = k.channelize_complex_plain(x, taps)
    err = float((y - yp).abs().max())
    check(torch.allclose(torch.view_as_real(y), torch.view_as_real(yp),
                         rtol=MAG_TOL, atol=MAG_TOL),
          f"B9 main shape: off by {err:.3g}")
    del yp
    rows.append(kernel_row(
        "channelize_complex", "channelizer.cu", "channelizer_kernel.py:224",
        err, False,
        time_ms(lambda: k.channelize_complex(x, taps)),
        time_ms(lambda: k.channelize_complex_plain(x, taps), reps=3, warmup=1),
        None, n_bytes=n_bytes_of(x, y) + n_w, **dft_ops(m, p, t_len),
        shape=f"M={m} T={t_len}"))


def kernels_main_shape(xq, pipe):
    """Every kernel against its plain version, and timed, at the main
    path's shapes, on the dense capture."""
    import torch

    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    m, t_len = M_MAIN, FRAMES_MAIN
    taps = pipe.channelizer.taps_rev
    cfg = pipe.pdw_cfg
    p = taps.shape[0]
    got = k.channelize_streams_packed_cm2(xq, taps, BIT_WIDTH,
                                          cfg.saturation_level)
    torch.cuda.synchronize()
    res1 = compare_streams(xq, taps, BIT_WIDTH, cfg.saturation_level, got,
                           "K1 main shape")
    mag, dph, satcs = got
    rows = []

    def row(*a, **kw):
        rows.append(kernel_row(*a, **kw))

    # K1: capture read once, three streams written once; FIR + four products
    row("channelize_streams_packed_cm2", "channelizer.cu",
        "channelizer_kernel.py:718", res1["mag_err"], False,
        time_ms(lambda: k.channelize_streams_packed_cm2(
            xq, taps, BIT_WIDTH, cfg.saturation_level)),
        time_ms(lambda: k.channelize_streams_packed_cm2_plain(
            xq, taps, BIT_WIDTH, cfg.saturation_level), reps=3, warmup=1),
        None,
        n_bytes=xq.numel() * xq.element_size() + 3 * 4 * m * t_len
        + 4 * (p * m + 4 * m * m), **dft_ops(m, p, t_len), **res1)

    # K2
    a, b = k.noise_floor_cm(mag, t_len), k.noise_floor_cm_plain(mag, t_len)
    check(same(a, b), f"K2 main shape: off by {max_abs(a, b):.3g}")
    nf = a
    row("noise_floor_cm", "noise_floor.cu", "nf_kernel.py:112",
        max_abs(a, b), True,
        time_ms(lambda: k.noise_floor_cm(mag, t_len)),
        time_ms(lambda: k.noise_floor_cm_plain(mag, t_len), reps=3, warmup=1),
        time_ms(lambda: torch.sort(mag[:, :t_len], dim=1), reps=3, warmup=1),
        n_bytes=4 * m * t_len + 4 * m, n_flop=0,
        device_ms=device_ms(lambda: k.noise_floor_cm(mag, t_len)),
        buffer_fits=_nf_fits(mag, t_len))

    # K3
    lead = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
    a = k.latch_cumsums_cm(mag, lead, lead, m)
    b = k.latch_cumsums_cm_plain(mag, lead, lead, m)
    check(same(a, b), f"K3 main shape: off by {max_abs(a, b):.3g}")
    packed = a
    del b
    row("latch_cumsums_cm", "latch.cu", "latch_kernel.py:211",
        0.0, True,
        time_ms(lambda: k.latch_cumsums_cm(mag, lead, lead, m)),
        time_ms(lambda: k.latch_cumsums_cm_plain(mag, lead, lead, m),
                reps=3, warmup=1),
        None, n_bytes=(4 + 8) * m * t_len + 12 * m, n_flop=0,
        device_ms=device_ms(lambda: k.latch_cumsums_cm(mag, lead, lead, m)))

    # K4: the two tier calls of a step, on the slots this capture gives
    toa, te = slot_grids(packed, m, cfg.max_pulses, t_len)
    plen = te - toa + 1
    closed = (toa < t_len) & (te < t_len)
    tiny = closed & (plen <= 2)
    short = closed & ~tiny & (plen <= 128)
    long_ = (toa < t_len) & ~tiny & ~short
    sentinel = torch.full((), t_len, dtype=torch.int32, device=toa.device)
    tiers = [(torch.where(s, toa, sentinel), torch.where(s, te, sentinel), w)
             for s, w in ((short, 128), (long_, cfg.max_pulse_samples))]
    err = 0.0
    live_bytes = 0
    for t_s, e_s, w in tiers:
        a = k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
        b = k.pulse_stats_plain(mag, dph, t_s, e_s, w, t_len)
        check(same(a[0], b[0]) and same(a[1], b[1]),
              f"K4 main shape window={w}: off by {max_abs(a[0], b[0]):.3g}"
              f" / {max_abs(a[1], b[1]):.3g}")
        err = max(err, max_abs(a[0], b[0]), max_abs(a[1], b[1]))
        live = t_s < t_len
        n_mag = (torch.minimum(t_s + torch.clamp(e_s - t_s + 1, max=w),
                               sentinel) - t_s).clamp(min=0)
        # each live sample of both streams read once; per slot two indices
        # read and two medians written
        live_bytes += int((live * (2 * n_mag - 1).clamp(min=0)).sum()) * 4
        live_bytes += 4 * 4 * t_s.numel()
        del a, b
    k4_ms = time_ms(lambda: [k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
                             for t_s, e_s, w in tiers])
    plain_ms = time_ms(lambda: [k.pulse_stats_plain(mag, dph, t_s, e_s, w,
                                                    t_len)
                                for t_s, e_s, w in tiers], reps=3, warmup=1)
    slots = {"tiny": int(tiny.sum()), "short": int(short.sum()),
             "long": int(long_.sum())}
    grid_rows = torch.arange(m, device=toa.device).repeat_interleave(
        toa.shape[1])
    sort_ms = window_sort_ms(mag, dph, [(t_s, e_s, grid_rows, w)
                                        for t_s, e_s, w in tiers], t_len)
    row("pulse_stats", "pulse_stats.cu", "pulse_stats_kernel.py:771",
        err, True, k4_ms, plain_ms, sort_ms, n_bytes=live_bytes, n_flop=0,
        slots=slots, device_ms=stats_device_ms("pulse_stats", lambda: [
            k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
            for t_s, e_s, w in tiers]))

    # B10: the same two tier calls with batch_tiles = 8, as the cm2 tail
    # makes them with _STATS_BATCH = 8: 8 tiles a batch at window 128, 5 at
    # window 1024; bit for bit K4's and the plain version's
    nts = [psk.batched_tiles(8, w, t_s.numel()) for t_s, _, w in tiers]
    check(nts == [8, 5], f"B10 main shape: {nts} tiles a batch, not [8, 5]")
    for t_s, e_s, w in tiers:
        a = k.pulse_stats(mag, dph, t_s, e_s, w, t_len, batch_tiles=8)
        b = k.pulse_stats_plain(mag, dph, t_s, e_s, w, t_len, batch_tiles=8)
        c = k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
        check(same(a[0], b[0]) and same(a[1], b[1]) and same(a[0], c[0])
              and same(a[1], c[1]), f"B10 main shape window={w}: differs "
                                    f"from plain or from K4")
        del a, b, c
    live_tiles = [int(psk._live_tiles(t_s.reshape(-1), t_len, nt)[1])
                  for (t_s, _, _), nt in zip(tiers, nts)]
    row("pulse_stats_batched", "pulse_stats.cu", "pulse_stats_kernel.py:445",
        0.0, True,
        time_ms(lambda: [k.pulse_stats(mag, dph, t_s, e_s, w, t_len,
                                       batch_tiles=8)
                         for t_s, e_s, w in tiers]),
        plain_ms, sort_ms, n_bytes=live_bytes, n_flop=0, equals_k4=True,
        device_ms=stats_device_ms("pulse_stats_batched", lambda: [
            k.pulse_stats(mag, dph, t_s, e_s, w, t_len, batch_tiles=8)
            for t_s, e_s, w in tiers]),
        k4_ms=k4_ms, tiles_a_batch=nts, live_tiles=live_tiles,
        tiles=[-(-t_s.numel() // psk.TILE) for t_s, _, _ in tiers],
        slots=slots)
    # mag and dph stay bound: the statistics rows' calls read them
    del got, satcs, packed
    kernels_block_shape(xq, pipe, row)
    return rows


def kernels_block_shape(xq, pipe, row):
    """The streamed path's kernels against their plain versions, and timed,
    at the streamed block's shape: block 1 of the dense capture with its
    halo, M = 64 x (65536 + 1024) frames, entered with the packed history of
    block 0's tail."""
    import torch

    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    m, t_len = M_MAIN, BLOCK_FRAMES + HALO_FRAMES
    taps = pipe.channelizer.taps_rev
    cfg = pipe.pdw_cfg
    p = taps.shape[0]
    f0 = BLOCK_FRAMES
    blk = xq[f0 * m: (f0 + t_len) * m]
    hist = xq[(f0 - (p - 1)) * m: f0 * m]
    sat_level = cfg.saturation_level

    # B6: against plain, and mag_cm / dph_cm the same bits as K1's
    cm = k.channelize_streams_packed_cm(blk, taps, BIT_WIDTH, sat_level,
                                        history=hist)
    torch.cuda.synchronize()
    res = compare_streams(blk, taps, BIT_WIDTH, sat_level, cm,
                          "B6 block shape", history=hist)
    k1 = k.channelize_streams_packed_cm2(blk, taps, BIT_WIDTH, sat_level,
                                         history=hist)
    check(same(cm[1], k1[0]) and same(cm[2], k1[1])
          and same(torch.cumsum(cm[3], dim=1), k1[2]),
          "B6 block shape: streams are not K1's bits")
    del k1
    mag_tm, mag, dph, sat = cm
    row("channelize_streams_packed_cm", "channelizer.cu",
        "channelizer_kernel.py:655", res["mag_err"], False,
        time_ms(lambda: k.channelize_streams_packed_cm(
            blk, taps, BIT_WIDTH, sat_level, history=hist)),
        time_ms(lambda: k.channelize_streams_packed_cm_plain(
            blk, taps, BIT_WIDTH, sat_level, history=hist), reps=3, warmup=1),
        None,
        n_bytes=(blk.numel() + hist.numel()) * blk.element_size()
        + 4 * 4 * m * t_len + 4 * (p * m + 4 * m * m),
        **dft_ops(m, p, t_len), mag_cm_equals_k1=True,
        shape=f"M={m} T={t_len}", **res)

    # B7, entered with a mixed state
    nf = k.noise_floor_cm(mag, t_len)
    lead = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
    entry = (torch.arange(m, device=mag.device) % 2).to(torch.float32)
    a = k.latch_cumsums(mag_tm, lead, lead, entry)
    b = k.latch_cumsums_plain(mag_tm, lead, lead, entry)
    check(same(a, b), f"B7 block shape: off by {max_abs(a, b):.3g}")
    c = k.latch_cumsums_cm(mag, lead, lead, m, entry)
    check(same(c, k.latch_cumsums_cm_plain(mag, lead, lead, m, entry)),
          "K3 block shape, entered active: differs from plain")
    check(same(a, c), "B7 block shape: differs from K3 on the flip")
    del c
    del b
    row("latch_cumsums", "latch.cu", "latch_kernel.py:283", 0.0, True,
        time_ms(lambda: k.latch_cumsums(mag_tm, lead, lead, entry)),
        time_ms(lambda: k.latch_cumsums_plain(mag_tm, lead, lead, entry),
                reps=3, warmup=1),
        None, n_bytes=(4 + 8) * m * t_len + 12 * m, n_flop=0,
        shape=f"M={m} T={t_len}")

    # K4 with the saturation mask: the slot grid at the full window, and the
    # two tiers as flat lists, as the streamed block's tail calls them
    packed = k.latch_cumsums(mag_tm, lead, lead)
    toa, te = slot_grids(packed, m, cfg.max_pulses, t_len)
    del packed, a
    w = cfg.max_pulse_samples
    plen = te - toa + 1
    closed = (toa < t_len) & (te < t_len)
    tiny = closed & (plen <= 2)
    short = closed & ~tiny & (plen <= 128)
    long_ = (toa < t_len) & ~tiny & ~short
    sentinel = torch.full((), t_len, dtype=torch.int32, device=toa.device)
    chan = torch.arange(m, dtype=torch.int32,
                        device=toa.device).repeat_interleave(toa.shape[1])

    def stats_bytes(t_s, e_s, win, per_slot):
        live = t_s < t_len
        n_mag = (torch.minimum(t_s + torch.clamp(e_s - t_s + 1, max=win),
                               sentinel) - t_s).clamp(min=0)
        # live samples of |y| and the phase step once, the interior of the
        # mask once; per slot its indices read and three values written
        n = (2 * n_mag - 1).clamp(min=0) + (n_mag - 2).clamp(min=0)
        return int((live * n).sum()) * 4 + per_slot * t_s.numel()

    grid = (torch.where(~tiny, toa, sentinel), torch.where(~tiny, te, sentinel))
    a = k.pulse_stats(mag, dph, *grid, w, t_len, sat)
    b = k.pulse_stats_plain(mag, dph, *grid, w, t_len, sat)
    check(all(same(x, y) for x, y in zip(a, b)),
          "K4 sat_cm block shape: differs from plain")
    grid_rows = chan.reshape(toa.shape)
    row("pulse_stats_sat", "pulse_stats.cu", "pulse_stats_kernel.py:771",
        max(max_abs(x, y) for x, y in zip(a, b)), True,
        time_ms(lambda: k.pulse_stats(mag, dph, *grid, w, t_len, sat)),
        time_ms(lambda: k.pulse_stats_plain(mag, dph, *grid, w, t_len, sat),
                reps=3, warmup=1),
        window_sort_ms(mag, dph, [(*grid, grid_rows, w)], t_len),
        n_bytes=stats_bytes(*grid, w, 8 + 12), n_flop=0,
        shape=f"M={m} T={t_len}", flagged=int(a[2].sum()),
        live_slots=int((grid[0] < t_len).sum()),
        device_ms=stats_device_ms("pulse_stats_sat", lambda: k.pulse_stats(mag, dph, *grid, w, t_len,
                                                  sat)))
    del a, b

    tiers = [(torch.where(s_, toa, sentinel).reshape(-1),
              torch.where(s_, te, sentinel).reshape(-1), win)
             for s_, win in ((short, 128), (long_, w))]
    err, n_bytes, flagged = 0.0, 0, 0
    for t_s, e_s, win in tiers:
        a = k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len)
        b = k.pulse_stats_dense_plain(mag, dph, sat, t_s, e_s, chan, win,
                                      t_len)
        check(all(same(x, y) for x, y in zip(a, b)),
              f"K4 dense block shape window={win}: differs from plain")
        err = max([err] + [max_abs(x, y) for x, y in zip(a, b)])
        n_bytes += stats_bytes(t_s, e_s, win, 12 + 12)
        flagged += int(a[2].sum())
        del a, b
    k4_ms = time_ms(lambda: [k.pulse_stats_dense(mag, dph, sat, t_s, e_s,
                                                 chan, win, t_len)
                             for t_s, e_s, win in tiers])
    plain_ms = time_ms(lambda: [k.pulse_stats_dense_plain(
        mag, dph, sat, t_s, e_s, chan, win, t_len)
        for t_s, e_s, win in tiers], reps=3, warmup=1)
    slots = {"tiny": int(tiny.sum()), "short": int(short.sum()),
             "long": int(long_.sum())}
    sort_ms = window_sort_ms(mag, dph, [(t_s, e_s, chan, win)
                                        for t_s, e_s, win in tiers], t_len)
    row("pulse_stats_dense", "pulse_stats.cu", "pulse_stats_kernel.py:771",
        err, True, k4_ms, plain_ms, sort_ms, n_bytes=n_bytes, n_flop=0,
        shape=f"M={m} T={t_len}", flagged=flagged, slots=slots,
        device_ms=stats_device_ms("pulse_stats_dense", lambda: [
            k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len)
            for t_s, e_s, win in tiers]))

    # B10 on the flat lists with the mask, as the streamed block's tail
    # calls it with _STATS_BATCH = 8: bit for bit K4's and the plain's
    for t_s, e_s, win in tiers:
        a = k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len,
                                batch_tiles=8)
        b = k.pulse_stats_dense_plain(mag, dph, sat, t_s, e_s, chan, win,
                                      t_len, batch_tiles=8)
        c = k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len)
        check(all(same(x, y) and same(x, z) for x, y, z in zip(a, b, c)),
              f"B10 dense block shape window={win}: differs from plain or "
              f"from K4")
        del a, b, c
    row("pulse_stats_dense_batched", "pulse_stats.cu",
        "pulse_stats_kernel.py:445", 0.0, True,
        time_ms(lambda: [k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan,
                                             win, t_len, batch_tiles=8)
                         for t_s, e_s, win in tiers]),
        plain_ms, sort_ms, n_bytes=n_bytes, n_flop=0,
        shape=f"M={m} T={t_len}", equals_k4=True, k4_ms=k4_ms,
        device_ms=stats_device_ms("pulse_stats_dense_batched", lambda: [
            k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len,
                                batch_tiles=8) for t_s, e_s, win in tiers]),
        tiles_a_batch=[psk.batched_tiles(8, win, t_s.numel())
                       for t_s, _, win in tiers], slots=slots)


def kernels_long_window(rows):
    """K4 at ``predict``'s window, 65,536, on one dwell of the scanning beam
    at its peak (one channel x 4,480,000 samples, synthesised on the card):
    the dwell's pulses, which keep the shared-memory path, plus slots of
    60,000 and 70,000 samples, longer than a warp's stretch of shared
    memory, which take the selection from device memory.  K2 takes the
    dwell's floor, against its plain version, and the fused one-channel
    streams are made from the dwell's complex capture, against theirs;
    returns both readings there."""
    import torch

    from sdr_channelizer_tpu_torch.capture import DeviceDwellEmitter
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk
    from sdr_channelizer_tpu_torch.ops.medians import median

    n = int(round(DWELL_SEC * EVENT_FS))
    w = PREDICT_WINDOW
    (xr, xi), _ = DeviceDwellEmitter(sample_rate_sps=EVENT_FS, **SCAN,
                                     device=DEVICE).receive(n, start_time=0.06)
    cfg = PdwConfig.event(max_pulse_samples=w)
    mag, ph, sat = pdwmod._prep_streams_planes(xr, xi, cfg.saturation_level)
    # K2 at the dwell's shape: the floor predict takes
    row1 = mag[None]
    nf = k.noise_floor_cm(row1, n)
    nf_plain = k.noise_floor_cm_plain(row1, n)
    check(same(nf, nf_plain) and same(nf.reshape(()), median(mag)),
          f"K2 predict shape: off by {max_abs(nf, nf_plain):.3g}")
    # the fused one-channel streams on the dwell as predict reads it: a
    # complex capture
    xc = torch.complex(xr, xi)
    level = cfg.saturation_level
    got = k.wideband_streams(xc, level)
    check(all(same(a, b) for a, b in
              zip(got, k.wideband_streams_plain(xc, level))),
          "wideband_streams predict shape: differs from plain")
    wide = {"shape": f"T={n}",
            "ms": time_ms(lambda: k.wideband_streams(xc, level)),
            "device_ms": device_ms(lambda: k.wideband_streams(xc, level)),
            "plain_ms": time_ms(lambda: k.wideband_streams_plain(xc, level),
                                reps=3, warmup=1),
            "library_ms": time_ms(lambda: wideband_library(xc, level),
                                  reps=3, warmup=1),
            "bound_ms": 20 * n / HBM_BYTES_PER_S * 1e3}
    del got, xc
    dwell = {"shape": f"M=1 T={n}",
             "ms": time_ms(lambda: k.noise_floor_cm(row1, n)),
             "device_ms": device_ms(lambda: k.noise_floor_cm(row1, n)),
             "plain_ms": time_ms(lambda: k.noise_floor_cm_plain(row1, n),
                                 reps=3, warmup=1),
             "library_ms": time_ms(lambda: torch.sort(mag), reps=3,
                                   warmup=1),
             "bound_ms": 4 * (n + 1) / HBM_BYTES_PER_S * 1e3,
             "buffer_fits": _nf_fits(row1, n)}
    lead, trail = (t.reshape(1) for t in pdwmod._thresholds(nf[0], cfg))
    packed = k.latch_cumsums(mag[:, None], lead, trail)
    check(same(packed, k.latch_cumsums_plain(mag[:, None], lead, trail)),
          "B7 predict shape: differs from plain")
    # B7's row carries the predict dwell's shape too
    b7 = next(r for r in rows if r["name"] == "latch_cumsums")
    b7["predict_shape"] = {
        "shape": f"M=1 T={n}",
        "ms": time_ms(lambda: k.latch_cumsums(mag[:, None], lead, trail)),
        "bound_ms": 12 * n / HBM_BYTES_PER_S * 1e3}
    toa, te = slot_grids(packed, 1, 64, n)
    del packed
    real = int(((toa < n) & (te < n)).sum())
    check(real >= 10, f"K4 long window: {real} pulses in the dwell")
    toa[0, -2:] = torch.tensor([1000, 2_000_000], dtype=torch.int32)
    te[0, -2:] = torch.tensor([1000 + 59_999, 2_000_000 + 69_999],
                              dtype=torch.int32)
    mag_cm, dph_cm, sat_cm = k.cm_streams(mag[:, None], ph[:, None],
                                          sat[:, None])
    toa_f, te_f = toa.reshape(-1).contiguous(), te.reshape(-1).contiguous()
    chan = torch.zeros_like(toa_f)
    live = toa_f < n
    n_mag = torch.minimum(torch.clamp(te_f - toa_f + 1, max=w), n - toa_f)
    n_long = int((live & (n_mag > psk.BLOCK_KEYS)).sum())
    check(n_long == 2 and int((live & (n_mag > 1000)).sum()) == 2,
          f"K4 long window: {n_long} slots past the stretch")

    def call():
        return k.pulse_stats_dense(mag_cm, dph_cm, sat_cm, toa_f, te_f, chan,
                                   w, n)

    before = psk.launches_long_window
    a = call()
    b = k.pulse_stats_dense_plain(mag_cm, dph_cm, sat_cm, toa_f, te_f, chan,
                                  w, n)
    g = k.pulse_stats(mag_cm, dph_cm, toa, te, w, n, sat_cm)
    torch.cuda.synchronize()
    check(psk.launches_long_window == before + 2,
          "K4 long window: the launches were not counted as such")
    check(all(same(x, y) and same(x, z.reshape(-1))
              for x, y, z in zip(a, b, g)),
          "K4 long window: differs from plain or grid form")
    check(bool(torch.isfinite(a[0][live]).all()),
          "K4 long window: a live median is not finite")
    # live samples of |y|, the phase step and the mask's interior once; a
    # slot's three indices read and three values written
    per = live * ((2 * n_mag - 1).clamp(min=0) + (n_mag - 2).clamp(min=0))
    n_bytes = int(per.sum()) * 4 + 24 * toa_f.numel()
    rows.append(kernel_row(
        "pulse_stats_long_window", "pulse_stats.cu",
        "pulse_stats_kernel.py:771", 0.0, True, time_ms(call),
        time_ms(lambda: k.pulse_stats_dense_plain(
            mag_cm, dph_cm, sat_cm, toa_f, te_f, chan, w, n), reps=3,
            warmup=1),
        window_sort_ms(mag_cm, dph_cm, [(toa_f, te_f, chan, w)], n),
        n_bytes=n_bytes, n_flop=0, shape=f"M=1 T={n}", window=w,
        pulses=real, slots_past_shared_memory=n_long,
        stretch=psk.BLOCK_KEYS, device_ms=stats_device_ms("pulse_stats_long_window", call),
        ms_without_the_long_slots=time_ms(lambda: k.pulse_stats_dense(
            mag_cm, dph_cm, sat_cm, toa_f[:-2].contiguous(),
            te_f[:-2].contiguous(), chan[:-2].contiguous(), w, n))))
    return {"noise_floor": dwell, "wideband_streams": wide}


def pdws_agree(a: dict, b: dict, where: str) -> None:
    check(len(a["toa"]) == len(b["toa"]),
          f"{where}: {len(a['toa'])} pulses vs {len(b['toa'])}")
    for key in ("toa", "pw", "channel", "sat"):
        check(np.array_equal(a[key], b[key]), f"{where}: {key} differs")
    check(np.allclose(a["mag"], b["mag"], rtol=MAG_TOL, atol=MAG_TOL),
          f"{where}: mag differs")
    check(np.allclose(a["snr"], b["snr"], rtol=0, atol=SNR_TOL_DB),
          f"{where}: snr differs")
    fd = np.abs(a["freq"] - b["freq"])
    fd = fd[~(np.isnan(a["freq"]) & np.isnan(b["freq"]))]
    check(fd.size == 0 or float(fd.max()) <= FREQ_TOL_HZ,
          f"{where}: freq differs")


def recovers_generator(pdws: dict, n: int, m: int) -> dict:
    """Every generated pulse of the sparse capture that the other train does
    not overwrite is found in its channel, its TOA within the channelizer's
    group delay (P frames)."""
    fs = m * 1e6
    amp, trains = pulse_trains(True)
    spans = []
    for k, (f0, pw, pri) in enumerate(trains):
        pw_n, pri_n = int(pw * fs), int(pri * fs)
        spans.append((f0, pw_n, np.arange(137 + k * 1000, n - pw_n, pri_n)))
    found = expected = 0
    for i, (f0, pw_n, starts) in enumerate(spans):
        _, opw, ostarts = spans[1 - i]
        chan = m // 2 + int(round(f0 / 1e6))
        toas = np.sort(pdws["toa"][pdws["channel"] == chan])
        for s in starts:
            lo = np.searchsorted(ostarts, s - opw - 16 * m)
            if lo < len(ostarts) and ostarts[lo] < s + pw_n + 16 * m:
                continue  # the trains collide here
            expected += 1
            j = np.searchsorted(toas, s / fs - 12e-6)
            found += int(j < len(toas) and toas[j] <= s / fs + 12e-6)
    total = sum(len(s[2]) for s in spans)
    check(found == expected,
          f"sparse capture: {found} of {expected} generated pulses found")
    check(len(pdws["toa"]) <= 1.1 * total,
          f"sparse capture: {len(pdws['toa'])} pulses for {total} generated")
    return {"generated": total, "clear_of_collisions": expected,
            "recovered": found}


def phase_main_path(pipe, caps):
    """The main path at full width through ``extract_fused``."""
    import torch

    from sdr_channelizer_tpu_torch.ops.cuda import (
        channelizer_kernel, latch_kernel, nf_kernel, pulse_stats_kernel)

    mods = {"channelize_streams_packed_cm2": channelizer_kernel,
            "noise_floor_cm": nf_kernel, "latch_cumsums_cm": latch_kernel,
            "pulse_stats": pulse_stats_kernel}
    n = M_MAIN * FRAMES_MAIN
    fs = M_MAIN * 1e6
    for mod in mods.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = {}
    pdws = {}
    for name, samples in caps.items():
        t0 = time.perf_counter()
        pdws[name] = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
        torch.cuda.synchronize()
        out[name] = {"pulses": len(pdws[name]["toa"]),
                     "extract_fused_s": round(time.perf_counter() - t0, 4)}
    launches = {name: mod.launches for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")

    for name, samples in caps.items():
        for key in ("toa", "freq", "pw", "mag", "snr"):
            vals = pdws[name][key]
            ok = np.isfinite(vals) | (np.isnan(vals) if key == "freq" else False)
            check(bool(ok.all()), f"{name}: non-finite {key}")
        check(out[name]["pulses"] > 0, f"{name}: no pulses")
        plain = pipe.extract_fused(samples, BIT_WIDTH, fs=fs, plain=True)
        out[name]["pulses_plain"] = len(plain["toa"])
        if name == "sparse":
            pdws_agree(pdws[name], plain, "sparse capture, kernels vs plain")
            out[name].update(recovers_generator(pdws[name], n, M_MAIN))
        else:
            band = DENSE_COUNT_BAND * len(plain["toa"])
            check(abs(len(pdws[name]["toa"]) - len(plain["toa"])) <= band,
                  f"dense capture: {len(pdws[name]['toa'])} pulses vs "
                  f"{len(plain['toa'])} from the plain versions")
        del plain
        # step time with the payload already on the card
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        step = time_ms(lambda: pipe.forward_packed(xq, BIT_WIDTH), reps=5)
        out[name]["step_ms"] = step
        out[name]["msamples_per_s"] = n / step / 1e3
        del xq
    emit("main_path", bands=M_MAIN, frames=FRAMES_MAIN, samples=n,
         bit_width=BIT_WIDTH, max_pulses=pipe.pdw_cfg.max_pulses,
         max_pulse_samples=pipe.pdw_cfg.max_pulse_samples,
         launches=launches, peak_memory_bytes=peak, **out)
    return launches


def write_segment(tmp: str, parts, fs: float, t0: float) -> None:
    """Contiguous ``.iq`` files, one per part, start times continuing."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    done = 0
    for i, part in enumerate(parts):
        hdr = iqpacket.IqHeader(
            frequency_hz=0.0, bandwidth_hz=fs, sample_rate_sps=fs,
            rx_gain_db=0, num_samples=len(part), bit_width=BIT_WIDTH,
            sample_start_time=t0 + done / fs)
        iqpacket.write_iq(os.path.join(tmp, f"dwell{i:02d}.iq"), hdr, part)
        done += len(part)


def _counters(names: dict) -> dict:
    """``{name: (wrapper module, its counter's attribute)}`` for ``names``,
    a dict of name -> "module.attribute" under ``ops.cuda``."""
    import importlib

    out = {}
    for name, where in names.items():
        mod, attr = where.split(".")
        out[name] = (importlib.import_module(
            f"sdr_channelizer_tpu_torch.ops.cuda.{mod}"), attr)
    return out


def read_counts(names: dict) -> dict:
    return {n: getattr(m, a) for n, (m, a) in _counters(names).items()}


def reset_counts(names: dict) -> None:
    for mod, attr in _counters(names).values():
        setattr(mod, attr, 0)


STREAM_COUNTS = {
    "channelize_streams_packed_cm": "channelizer_kernel.launches_cm",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_sat": "pulse_stats_kernel.launches",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}
WIDEBAND_COUNTS = {
    "noise_floor_wideband": "nf_kernel.launches",
    "latch_cumsums_wideband": "latch_kernel.launches_tm",
    "wideband_streams": "transpose_kernel.launches_wideband",
    "cm_streams_wideband": "transpose_kernel.launches",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}
ROUTE_COUNTS = {
    "noise_floor_cm": "nf_kernel.launches",
    "channelize_streams_packed": "channelizer_kernel.launches_flat",
    "cm_streams": "transpose_kernel.launches",
    "channelize_complex": "channelizer_kernel.launches_complex",
    "channelize_cm": "channelizer_kernel.launches_cm",
    "channelize_cm2": "channelizer_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}


def stream_counts():
    return read_counts(STREAM_COUNTS)


def reset_stream_counts() -> None:
    reset_counts(STREAM_COUNTS)


def pdws_identical(a: dict, b: dict, where: str) -> None:
    for key in a:
        check(np.array_equal(a[key], b[key], equal_nan=True),
              f"{where}: {key} is not bit-identical")


def phase_streaming(pipe, caps):
    """The streamed path at full width: the sparse capture four times over
    as four contiguous files (67,108,864 samples, 16 blocks), held against
    single-shot extraction of the same samples, its plain run and its own
    resume; then the dense capture as one file."""
    import torch

    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.streaming import (
        CaptureSet, StreamingExtractor)
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    fs = M_MAIN * 1e6
    t0 = 1723800000.0
    cfg = pipe.pdw_cfg
    n_blocks = STREAM_FILES * FRAMES_MAIN // BLOCK_FRAMES
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_segment(tmp, [caps["sparse"]] * STREAM_FILES, fs, t0)
        cset = CaptureSet.from_dir(tmp)
        check(len(cset.segments) == 1
              and len(cset.segments[0].paths) == STREAM_FILES,
              "streaming: the four files are not one contiguous segment")
        seg = cset.segments[0]
        n = seg.num_samples
        ext = StreamingExtractor(pipe.channelizer, cfg,
                                 block_frames=BLOCK_FRAMES, device=DEVICE)
        ck = os.path.join(tmp, "ck")

        reset_stream_counts()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        got = ext.extract_segment_fused(seg, checkpoint_dir=ck)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = stream_counts()
        peak = torch.cuda.max_memory_allocated()
        # (e) floor pass and detect pass of every block went through B6, the
        # detect pass through B7 and both statistics tiers
        check(launches["channelize_streams_packed_cm"] == 2 * n_blocks
              and launches["latch_cumsums"] == n_blocks
              and launches["pulse_stats_dense"] >= n_blocks,
              f"streaming: launch counts {launches} for {n_blocks} blocks")
        check(ext.counters.get("nf_device_count_d2h_bytes") > 0,
              "streaming: the noise floor did not take the device counts")
        check(len(got["toa"]) > 0, "streaming: no pulses")

        # (a) single-shot extraction of the same samples; its slot cap is
        # per capture, the streamed one per block, so it gets four times
        # the slots
        single = ChannelizerPipeline(
            pipe.channelizer, PdwConfig.channelized(
                max_pulses=STREAM_FILES * cfg.max_pulses,
                max_pulse_samples=cfg.max_pulse_samples), DEVICE)
        whole = np.concatenate([caps["sparse"]] * STREAM_FILES)
        nf1, _, batch = single.forward_packed(
            torch.as_tensor(pack(whole)), BIT_WIDTH)
        ref = single._finalize(batch, fs, 0.0, t0)
        del batch, whole
        check(int(ref["channel"].size) > 0 and np.bincount(
            ref["channel"]).max() < single.pdw_cfg.max_pulses,
            "streaming: the single-shot reference hit its slot cap")
        pdws_agree(got, ref, "streaming vs single-shot")
        check(np.array_equal(got["mag"], ref["mag"]),
              "streaming vs single-shot: mag differs")
        # (d) the streamed floor is the single-shot K2 floor
        nf_s = np.load(os.path.join(ck, "noise_floor.npz"))["nf"]
        check(np.array_equal(nf_s, nf1.cpu().numpy()),
              "streaming: noise floor differs from the single-shot one")
        del nf1, ref
        torch.cuda.empty_cache()

        # (c) resume after losing the last two blocks
        files = sorted(f for f in os.listdir(ck) if f.startswith("block_"))
        check(len(files) == n_blocks, f"streaming: {len(files)} checkpoints")
        for f in files[-2:]:
            os.remove(os.path.join(ck, f))
        ext2 = StreamingExtractor(pipe.channelizer, cfg,
                                  block_frames=BLOCK_FRAMES, device=DEVICE)
        resumed = ext2.extract_segment_fused(seg, checkpoint_dir=ck)
        pdws_identical(resumed, got, "streaming, resumed")
        n_resumed = int(ext2.counters.get("blocks_resumed_from_checkpoint"))
        check(n_resumed == n_blocks - 2,
              f"streaming: {n_resumed} blocks resumed")

        # (b) the same run through the plain versions
        plain = StreamingExtractor(
            pipe.channelizer, cfg, block_frames=BLOCK_FRAMES, device=DEVICE,
            plain=True).extract_segment_fused(seg)
        pdws_agree(got, plain, "streaming, kernels vs plain")
        for key in ("toa", "freq", "pw", "mag", "snr"):
            vals = got[key]
            ok = np.isfinite(vals) | (np.isnan(vals) if key == "freq" else False)
            check(bool(ok.all()), f"streaming: non-finite {key}")
        out["sparse_four_files"] = {
            "files": STREAM_FILES, "samples": n, "blocks": n_blocks,
            "pulses": len(got["toa"]), "pulses_plain": len(plain["toa"]),
            "equals_single_shot": True, "equals_plain": True,
            "resume_bit_identical": True, "blocks_resumed": n_resumed,
            "noise_floor_equals_single_shot": True,
            "wall_s": wall, "msamples_per_s": n / wall / 1e6,
            "peak_memory_bytes": peak, "launches": dict(launches),
            "counters": ext.counters.snapshot()["counters"]}
        del plain, resumed

    # the dense capture as one file: every channel at its slot cap in every
    # block, all pulses short, so max_pulse_samples = 128 holds them and the
    # single-tier form (the slot grid with the mask) is what runs
    dcfg = PdwConfig.channelized(max_pulses=cfg.max_pulses,
                                 max_pulse_samples=128)
    with tempfile.TemporaryDirectory() as tmp:
        write_segment(tmp, [caps["dense"]], fs, t0)
        seg = CaptureSet.from_dir(tmp).segments[0]
        reset_stream_counts()
        got = StreamingExtractor(
            pipe.channelizer, dcfg, block_frames=BLOCK_FRAMES,
            device=DEVICE).extract_segment_fused(seg)
        dense_launches = stream_counts()
        plain = StreamingExtractor(
            pipe.channelizer, dcfg, block_frames=BLOCK_FRAMES, device=DEVICE,
            plain=True).extract_segment_fused(seg)
    band = DENSE_COUNT_BAND * len(plain["toa"])
    check(abs(len(got["toa"]) - len(plain["toa"])) <= band,
          f"streaming, dense capture: {len(got['toa'])} pulses vs "
          f"{len(plain['toa'])} from the plain versions")
    check(dense_launches["pulse_stats_sat"] > 0,
          "streaming, dense capture: the slot-grid statistics never ran")
    out["dense_one_file"] = {
        "samples": seg.num_samples,
        "blocks": FRAMES_MAIN // BLOCK_FRAMES, "pulses": len(got["toa"]),
        "pulses_plain": len(plain["toa"]),
        "saturated": int(got["sat"].sum()), "launches": dense_launches}
    launches["pulse_stats_sat"] = dense_launches["pulse_stats_sat"]
    emit("streaming", bands=M_MAIN, block_frames=BLOCK_FRAMES,
         halo_frames=HALO_FRAMES, bit_width=BIT_WIDTH,
         max_pulses=cfg.max_pulses,
         max_pulse_samples=cfg.max_pulse_samples, **out)
    return launches


def wideband_capture(n: int, pri_sec: float, start_index: int, seed: int):
    """A pulse train of the port's own generator that clears the wideband
    detector's 18 dB: amplitude 0.5 over noise of 0.001 a component, pulses
    of 2800 samples.  Returns ``(spec, complex64 capture)``."""
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec, pulse_train)

    spec = PulseTrainSpec(sample_rate_sps=WIDE_FS, duration_sec=n / WIDE_FS,
                          frequency_hz=7.3e6, pulse_width_sec=50e-6,
                          pri_sec=pri_sec, start_index=start_index,
                          amplitude=0.5, noise_std=1e-3)
    check(spec.num_samples == n, f"wideband capture: {spec.num_samples} "
                                 f"samples for {n}")
    return spec, np.ascontiguousarray(pulse_train(spec, seed=seed),
                                      np.complex64)


def phase_wideband(rows, dwells: dict):
    """The wideband path at a real size: 16,000,000 complex samples through
    ``WidebandPdwPipeline.extract`` on the card, against the same call with
    the plain versions and against the generator's pulses; the fused
    one-channel streams, K2 (the floor), B7 and B8 at one channel against
    their plain versions, and timed (the fused form's and K2's rows carry
    their readings at one ``predict`` dwell, ``dwells``); then 2^25 samples
    through the blocked route, B8 a block, against the oracle extractor."""
    import torch

    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.signal.synth import pulse_starts

    cfg = PdwConfig.wideband(max_pulses=512, max_pulse_samples=4096)
    pipe = WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg), DEVICE)
    n = WIDE_SAMPLES
    spec, iq = wideband_capture(n, 1e-3, 1234, seed=3)
    t0 = 100.0   # an epoch time would cost float64 a sample's worth of TOA
    out = {}

    reset_counts(WIDEBAND_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    got = pipe.extract(iq, fs=WIDE_FS, sample_start_time=t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_counts(WIDEBAND_COUNTS)
    peak = torch.cuda.max_memory_allocated()
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

    # the step with the capture on the card, and its parts one by one
    x = torch.as_tensor(iq, device=DEVICE)
    step = time_ms(lambda: pipe.forward(x), reps=3, warmup=1)
    level = cfg.saturation_level
    mag, ph, sat = pdwmod._prep_streams(x, level)
    # the fused one-channel streams, on the capture (16-byte loads) and on a
    # copy one sample off a 16-byte boundary (a pair a load), bit for bit
    # the plain chain
    fused = k.wideband_streams_plain(x, level)
    check(same(fused[0], mag), "wideband_streams: mag is not |x|")
    x_off = off_boundary(x)
    for loads, xs in (("16-byte", x), ("pair", x_off)):
        streams = k.wideband_streams(xs, level)
        check(all(same(a, b) for a, b in zip(streams, fused)),
              f"wideband_streams 16M, {loads} loads: differs from plain")
    del streams
    rows.append(kernel_row(
        "wideband_streams", "transpose.cu", "transpose_kernel.py:136", 0.0,
        True, time_ms(lambda: k.wideband_streams(x, level)),
        time_ms(lambda: k.wideband_streams_plain(x, level), reps=3,
                warmup=1),
        time_ms(lambda: wideband_library(x, level), reps=3, warmup=1),
        n_bytes=20 * n, n_flop=0, shape=f"T={n}",
        device_ms=device_ms(lambda: k.wideband_streams(x, level)),
        scalar_loads_device_ms=device_ms(
            lambda: k.wideband_streams(x_off, level)),
        fuses="sdr_channelizer_tpu/dsp/pdw.py:358 (_prep_streams)",
        predict_shape=dwells["wideband_streams"]))
    del x_off
    row1 = mag[None]   # the capture's magnitude as K2's one row
    nf = k.noise_floor_cm(row1, n)
    nf_plain = k.noise_floor_cm_plain(row1, n)
    check(same(nf, nf_plain), f"K2 wideband shape: off by "
                              f"{max_abs(nf, nf_plain):.3g}")
    check(same(nf.reshape(()), pipe.forward(x)[0]),
          "wideband: the step's floor is not K2's")
    nf = nf.reshape(())
    lead, trail = (t.reshape(1) for t in pdwmod._thresholds(nf, cfg))
    mag2, ph2, sat2 = mag[:, None], ph[:, None], sat[:, None]
    parts = {
        "wideband_streams_ms": time_ms(lambda: k.wideband_streams(x, level),
                                       reps=3, warmup=1),
        "noise_floor_ms": time_ms(lambda: k.noise_floor_cm(row1, n), reps=3,
                                  warmup=1),
    }
    rows.append(kernel_row(
        "noise_floor_wideband", "noise_floor.cu", "nf_kernel.py:112", 0.0,
        True, time_ms(lambda: k.noise_floor_cm(row1, n)),
        time_ms(lambda: k.noise_floor_cm_plain(row1, n), reps=3, warmup=1),
        time_ms(lambda: torch.sort(mag), reps=3, warmup=1),
        n_bytes=4 * n + 4, n_flop=0, shape=f"M=1 T={n}",
        device_ms=device_ms(lambda: k.noise_floor_cm(row1, n)),
        buffer_fits=_nf_fits(row1, n), predict_shape=dwells["noise_floor"]))

    # B7 at one channel
    a = k.latch_cumsums(mag2, lead, trail)
    b = k.latch_cumsums_plain(mag2, lead, trail)
    check(same(a, b), f"B7 wideband shape: off by {max_abs(a, b):.3g}")
    check(int(a[0, -1]) == len(starts), "B7 wideband shape: edge count")
    del b
    rows.append(kernel_row(
        "latch_cumsums_wideband", "latch.cu", "latch_kernel.py:283", 0.0, True,
        time_ms(lambda: k.latch_cumsums(mag2, lead, trail), reps=3, warmup=1),
        time_ms(lambda: k.latch_cumsums_plain(mag2, lead, trail), reps=3,
                warmup=1),
        None, n_bytes=n_bytes_of(mag2, a), n_flop=0, shape=f"M=1 T={n}"))
    del a

    # B8 at one channel on the whole 16M capture (the blocked path's row
    # below carries this reading): mag_cm is a view of mag, so the bound
    # counts the phase and the bool mask read, dph_cm and the float mask
    # written: 13 bytes a sample
    a = k.cm_streams(mag2, ph2, sat2)
    check(all(same(u, v) for u, v in
              zip(a, k.cm_streams_plain(mag2, ph2, sat2)))
          and a[0].data_ptr() == mag2.data_ptr(),
          "B8 at M = 1 x 16M: differs from plain")
    b8_whole = {
        "shape": f"M=1 T={n}",
        "ms": time_ms(lambda: k.cm_streams(mag2, ph2, sat2)),
        "device_ms": device_ms(lambda: k.cm_streams(mag2, ph2, sat2)),
        "plain_ms": time_ms(lambda: k.cm_streams_plain(mag2, ph2, sat2),
                            reps=3, warmup=1),
        "bound_ms": n_bytes_of(ph2, sat2, a[1], a[2]) / HBM_BYTES_PER_S * 1e3}
    del a
    parts["tail_ms"] = time_ms(
        lambda: pdwmod._extract_wideband_from_streams(
            mag, None, None, cfg, nf, cm_streams=(mag[None], *fused[1:])),
        reps=3, warmup=1)
    out["single_shot"] = {
        "samples": n, "pulses": len(got["toa"]), "generated": len(starts),
        "toa_err_samples": float(toa_err.max()),
        "pw_err_samples": float(pw_err.max()),
        "freq_err_hz": float(f_err.max()), "equals_plain": True,
        "extract_s": wall, "step_ms": step,
        "msamples_per_s": n / step / 1e3, "peak_memory_bytes": peak,
        "launches": dict(launches), **parts}
    del x, mag, ph, sat, mag2, ph2, sat2, iq, plain, fused
    torch.cuda.empty_cache()

    # 2^25 samples: the blocked route.  One pulse straddles the first block
    # boundary, one clips, one is open at the end of the capture.
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
    torch.cuda.reset_peak_memory_stats()
    nf, batch = pipe.forward(x)
    torch.cuda.synchronize()
    blocked_launches = read_counts(WIDEBAND_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n_blocks = n // block
    check(blocked_launches["latch_cumsums_wideband"] == n_blocks
          and blocked_launches["cm_streams_wideband"] == n_blocks
          and blocked_launches["wideband_streams"] == 0
          and blocked_launches["noise_floor_wideband"] == 1,
          f"wideband, blocked: launch counts {blocked_launches}")
    check(same(nf.reshape(1), k.noise_floor_cm_plain(x.abs()[None], n)),
          "K2 at 2^25 samples: differs from plain")
    step = time_ms(lambda: pipe.forward(x), reps=3, warmup=1)
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
    # the row is timed on the first block, and on a copy of it one element
    # off a 16-byte boundary (the 4-byte loads)
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
    first, first_off = shapes["first"], shapes["first_off_boundary"]
    a = k.cm_streams(*first)
    rows.append(kernel_row(
        "cm_streams_wideband", "transpose.cu", "transpose_kernel.py:136", 0.0,
        True, time_ms(lambda: k.cm_streams(*first)),
        time_ms(lambda: k.cm_streams_plain(*first), reps=3, warmup=1),
        time_ms(lambda: flip_library(*first), reps=3, warmup=1),
        n_bytes=n_bytes_of(first[1], first[2], a[1], a[2]), n_flop=0,
        shape=f"M=1 T={h1} (a block and its halo)",
        device_ms=device_ms(lambda: k.cm_streams(*first)),
        scalar_loads_device_ms=device_ms(lambda: k.cm_streams(*first_off)),
        checked_blocks={w: int(t[0].shape[0]) for w, t in shapes.items()},
        whole_capture=b8_whole))
    del a, first, first_off, shapes, mag, ph, sat
    out["blocked"] = {
        "samples": n, "blocks": n_blocks, "pulses": count,
        "equals_oracle_on_exact_keys": True,
        "mag_equals_oracle_bit_for_bit": bool(
            np.array_equal(got_b.mag, ref_b.mag)),
        "step_ms": step, "msamples_per_s": n / step / 1e3,
        "peak_memory_bytes": peak, "launches": blocked_launches}
    del x, batch, ref
    torch.cuda.empty_cache()
    emit("wideband", max_pulses=cfg.max_pulses,
         max_pulse_samples=cfg.max_pulse_samples, fs=WIDE_FS,
         checked=["wideband_streams", "noise_floor_wideband",
                  "latch_cumsums_wideband", "cm_streams_wideband"], **out)
    # the statistics kernel's row counts the streamed path's launches; B8
    # at one channel runs on the blocked path
    del launches["pulse_stats_dense"]
    launches["cm_streams_wideband"] = blocked_launches["cm_streams_wideband"]
    return launches


def phase_routes(pipe, caps):
    """The single-shot routes ``"flat"`` and ``"cm"`` against ``"cm2"`` and
    against their own plain versions on the card at M = 64 x 262144 frames;
    a float32 payload against the int16 payload it
    was dequantized from; the complex-free step (``extract_planes``)."""
    import torch

    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel
    from sdr_channelizer_tpu_torch.ops.medians import median

    fs = M_MAIN * 1e6
    n = M_MAIN * FRAMES_MAIN

    def counts():
        return read_counts(ROUTE_COUNTS)

    def reset():
        reset_counts(ROUTE_COUNTS)

    out = {}
    launches = {}
    for name, samples in caps.items():
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        pdws, res, floors = {}, {}, {}
        for route in ("cm2", "flat", "cm"):
            reset()
            floors[route], _, batch = pipe.forward_packed(xq, BIT_WIDTH,
                                                          route=route)
            pdws[route] = pipe._finalize(batch, fs, 0.0, 0.0)
            seen = counts()
            # every route takes its floor with K2, once
            check(seen["noise_floor_cm"] == 1,
                  f"route {route}, {name}: launch counts {seen}")
            if route == "flat":
                check(seen["channelize_streams_packed"] == 1
                      and seen["cm_streams"] == 1
                      and seen["latch_cumsums"] == 1
                      and seen["pulse_stats_dense"] == 2,
                      f"route flat, {name}: launch counts {seen}")
                for key in ("channelize_streams_packed", "cm_streams"):
                    launches[key] = launches.get(key, 0) + seen[key]
            if route == "cm":
                check(seen["channelize_cm"] == 1 and seen["cm_streams"] == 0
                      and seen["latch_cumsums"] == 1,
                      f"route cm, {name}: launch counts {seen}")
            res[route] = {"noise_floor_launches": seen["noise_floor_cm"]}
            # one body gives every route the same magnitude: the same floor
            check(same(floors[route], floors["cm2"]),
                  f"route {route}, {name}: the floor differs from cm2's")
            res[route].update({
                "pulses": len(pdws[route]["toa"]),
                "step_ms": time_ms(lambda: pipe.forward_packed(
                    xq, BIT_WIDTH, route=route), reps=5)})
        for route in ("flat", "cm"):
            if name == "sparse":
                pdws_agree(pdws[route], pdws["cm2"],
                           f"route {route} vs cm2, sparse capture")
            else:
                band = DENSE_COUNT_BAND * len(pdws["cm2"]["toa"])
                check(abs(len(pdws[route]["toa"]) - len(pdws["cm2"]["toa"]))
                      <= band, f"route {route} vs cm2, dense capture: "
                               f"{len(pdws[route]['toa'])} pulses vs "
                               f"{len(pdws['cm2']['toa'])}")
            for key in ("toa", "pw", "channel", "sat"):
                check(np.array_equal(pdws[route][key], pdws["cm2"][key]),
                      f"route {route} vs cm2, {name} capture: {key} differs")
            res[route]["exact_keys_equal_cm2"] = True

            # the route against its plain versions on the card: the tail
            # alone on the streams the channelizer kernel gave (the latch,
            # the flip and the statistics kernels are exact, so the PDWs
            # are bit-identical), then the whole route (the channelizer's
            # plain version differs in the last place of a float32)
            front = {"flat": k.KERNELS.channelize_flat,
                     "cm": k.KERNELS.channelize_cm}[route]
            streams = front(xq, pipe.channelizer.taps_rev,
                            bit_width=BIT_WIDTH,
                            sat_level=pipe.pdw_cfg.saturation_level)
            tail = {}
            for label, ops in (("kernels", k.KERNELS), ("plain", k.PLAIN)):
                batch = pipe._fused_tail(route, lambda _: streams, ops)[2]
                tail[label] = pipe._finalize(batch, fs, 0.0, 0.0)
            del streams, batch
            where = f"route {route}, {name} capture"
            pdws_identical(tail["kernels"], pdws[route],
                           f"{where}: the tail alone vs the route")
            pdws_identical(tail["kernels"], tail["plain"],
                           f"{where}: tail kernels vs plain")
            res[route]["tail_equals_plain_bit_for_bit"] = True
            _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route=route,
                                              plain=True)
            plain = pipe._finalize(batch, fs, 0.0, 0.0)
            del batch
            res[route]["pulses_plain"] = len(plain["toa"])
            if name == "sparse":
                pdws_agree(pdws[route], plain, f"{where}: kernels vs plain")
            else:
                band = DENSE_COUNT_BAND * len(plain["toa"])
                check(abs(len(pdws[route]["toa"]) - len(plain["toa"]))
                      <= band, f"{where}: {len(pdws[route]['toa'])} pulses "
                               f"vs {len(plain['toa'])} from the plain "
                               f"versions")
        # the flat and cm routes' noise floor: K2 on the flip, where a sort
        # along the strided axis was
        mag = channelizer_kernel.channelize_streams_packed(
            xq, pipe.channelizer.taps_rev, BIT_WIDTH)[0]
        mag_cm = mag.T.contiguous()
        check(same(k.noise_floor_cm(mag_cm, FRAMES_MAIN),
                   median(mag, dim=0)),
              f"K2 route shape, {name}: differs from median(mag, dim=0)")
        res["noise_floor_ms"] = time_ms(
            lambda: k.noise_floor_cm(mag_cm, FRAMES_MAIN))
        res["median_dim0_ms"] = time_ms(lambda: median(mag, dim=0), reps=3,
                                        warmup=1)
        del mag, mag_cm, xq
        out[name] = res

    # a float32 payload takes the planes ingest of the cm2 form and gives
    # the int16 payload's PDWs; so does a complex capture through extract()
    samples = caps["sparse"]
    ref = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
    iq = iqpacket.to_complex(samples, BIT_WIDTH)
    as_float = np.stack([iq.real, iq.imag], -1)
    reset()
    got = pipe.extract_fused(as_float, 0, fs=fs)
    check(counts()["channelize_cm2"] == 1, "float payload: the cm2 form on "
                                           "planes was not launched")
    pdws_agree(got, ref, "float32 payload vs int16 payload")
    pdws_identical(got, ref, "float32 payload vs int16 payload")
    pdws_identical(pipe.extract(iq, fs=fs), ref,
                   "extract() of the complex capture vs int16 payload")
    # the complex-free step: B9, stream math in torch, the kernel tail
    reset()
    t0 = time.perf_counter()
    planes = pipe.extract_planes(iq, fs=fs)
    wall = time.perf_counter() - t0
    seen = counts()
    check(seen["channelize_complex"] == 1 and seen["cm_streams"] == 1,
          f"extract_planes: launch counts {seen}")
    launches["channelize_complex"] = seen["channelize_complex"]
    check(abs(len(planes["toa"]) - len(ref["toa"]))
          <= DENSE_COUNT_BAND * len(ref["toa"]),
          f"extract_planes: {len(planes['toa'])} pulses vs {len(ref['toa'])}")
    out["float_payload_equals_int16"] = True
    out["extract_planes"] = {
        "pulses": len(planes["toa"]), "extract_s": wall,
        **recovers_generator(planes, n, M_MAIN)}
    emit("routes", bands=M_MAIN, frames=FRAMES_MAIN, **out)
    return launches


def phase_stats_batch(pipe, caps):
    """B10 on its paths: ``extract_fused`` on both captures and route
    ``"cm"`` with ``dsp.pdw._STATS_BATCH = 8``, bit for bit the PDWs of the
    runs with 1 (K4); the steps timed in turns 1, 8, 8, 1."""
    import torch

    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    fs = M_MAIN * 1e6
    out = {}
    launches = {"pulse_stats_batched": 0, "pulse_stats_dense_batched": 0}
    try:
        for name, samples in caps.items():
            xq = torch.as_tensor(pack(samples), device=pipe.device)
            res = {}
            pdwmod._STATS_BATCH = 1
            ref = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
            _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route="cm")
            ref_cm = pipe._finalize(batch, fs, 0.0, 0.0)
            pdwmod._STATS_BATCH = 8
            psk.launches_batched = psk.launches = 0
            got = pipe.extract_fused(samples, BIT_WIDTH, fs=fs)
            torch.cuda.synchronize()
            n_b, n_k4 = psk.launches_batched, psk.launches
            check(n_b == 2 and n_k4 == 0, f"stats_batch, {name}: B10 "
                                          f"{n_b} / K4 {n_k4} launches")
            pdws_identical(got, ref, f"stats_batch, {name}: 8 vs 1")
            psk.launches_dense_batched = psk.launches_dense = 0
            _, _, batch = pipe.forward_packed(xq, BIT_WIDTH, route="cm")
            got_cm = pipe._finalize(batch, fs, 0.0, 0.0)
            torch.cuda.synchronize()
            n_db, n_dk4 = psk.launches_dense_batched, psk.launches_dense
            check(n_db == 2 and n_dk4 == 0, f"stats_batch, route cm, {name}:"
                                            f" B10 {n_db} / K4 {n_dk4}")
            pdws_identical(got_cm, ref_cm, f"stats_batch, route cm, {name}")
            launches["pulse_stats_batched"] += n_b
            launches["pulse_stats_dense_batched"] += n_db
            times = {1: [], 8: []}
            for bt in (1, 8, 8, 1):
                pdwmod._STATS_BATCH = bt
                times[bt].append(time_ms(
                    lambda: pipe.forward_packed(xq, BIT_WIDTH), reps=5))
            res.update(pulses=len(got["toa"]), pulses_cm=len(got_cm["toa"]),
                       identical=True, identical_cm=True,
                       step_ms_stats_batch_1=times[1],
                       step_ms_stats_batch_8=times[8])
            out[name] = res
            del xq
    finally:
        pdwmod._STATS_BATCH = 1
    emit("stats_batch", bands=M_MAIN, frames=FRAMES_MAIN, batch_tiles=8,
         launches=launches, **out)
    return launches


def phase_predict():
    """``predict`` on the card: eight consecutive 80 ms dwells of the
    scanning beam at 56 Msps written by the port's recorder, through the
    CLI in a process of its own and in-process; the in-process run against
    the same files with the plain versions, bit for bit."""
    import torch

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
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        radio = EmulatedRadio(sample_rate_sps=EVENT_FS, **SCAN,
                              start_epoch=1723800000.0)
        files = record_dwells(radio, rec, tmp)
        record_s = time.perf_counter() - t0
        check(len(files) == PREDICT_FILES, f"predict: {len(files)} files")

        reset_counts(counts)
        t0 = time.perf_counter()
        records, pred, base = predict_files(files, cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        # every dwell makes its streams with the fused form, and none flips
        check(launches["wideband_streams"] == PREDICT_FILES
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
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "sdr_channelizer_tpu_torch", "predict",
             *files], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f"predict CLI: exit {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        want = [f"{path}: event at +{ev:.6f}s, next predicted +{nxt:.6f}s"
                if nxt is not None else f"{path}: gated out / too few pulses"
                for path, _, ev, nxt in records]
        got_lines = res.stdout.splitlines()
        check(got_lines[:len(want)] == want,
              f"predict CLI: lines differ from the in-process run: "
              f"{got_lines[:3]} vs {want[:3]}")

        # per file on the card: the capture loaded, then extract
        pipe = WidebandPdwPipeline(cfg, DEVICE)
        per_file = []
        for path in files:
            iq, meta = load_capture(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.extract(iq, fs=float(meta["fs"]))
            torch.cuda.synchronize()
            per_file.append(time.perf_counter() - t0)
        x = torch.as_tensor(iq, device=DEVICE)
        step = time_ms(lambda: pipe.forward(x), reps=5)
    emit("predict", files=PREDICT_FILES, samples_per_file=rec.dwell_samples,
         fs=EVENT_FS, max_pulses=cfg.max_pulses,
         max_pulse_samples=cfg.max_pulse_samples,
         pulses=[len(p["toa"]) for _, p, _, _ in records],
         events=pred.events, next_event=records[-1][3] if records else None,
         equals_plain=True, cli_lines_equal=True, record_s=record_s,
         predict_files_s=wall, cli_s=cli_s, extract_s_per_file=per_file,
         step_ms=step, longest_pulse_samples=int(round(
             float(widths.max()) * EVENT_FS)) + 1, launches=launches)
    return {"pulse_stats_long_window": launches["pulse_stats_long_window"]}


SHARD_DEVICES = 4             # the sharded phase's shards, all on cuda:0
SHARD_MESHES = ((4, 1), (2, 2))
SHARDED_COUNTS = {
    "channelize_streams_packed_cm2": "channelizer_kernel.launches",
    "noise_floor_cm": "nf_kernel.launches",
    "latch_cumsums_cm": "latch_kernel.launches",
    "pulse_stats": "pulse_stats_kernel.launches"}
SHARDED_CM_COUNTS = {
    "channelize_streams_packed": "channelizer_kernel.launches_flat",
    "noise_floor_cm": "nf_kernel.launches",
    "cm_streams": "transpose_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}
SHARDED_WIDE_COUNTS = {
    "noise_floor_cm": "nf_kernel.launches",
    "cm_streams": "transpose_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}


def shard_slots(pdws: dict, slots: int, n_time: int) -> dict:
    """``pdws`` of the whole capture (at ``sample_start_time`` 0, the main
    path's 1 MHz frame rate) cut to what a step over ``n_time`` time shards
    keeps: ``max_pulses`` is a shard's slots a channel, so of each channel
    in each shard the first ``slots`` pulses by TOA, a pulse in the shard
    of its first frame (``toa = (i0 + 1) / fs``)."""
    i0 = np.rint(pdws["toa"] * FS_MAIN / M_MAIN).astype(np.int64) - 1
    cell = (i0 // (FRAMES_MAIN // n_time)) * M_MAIN + pdws["channel"]
    keep = np.zeros(len(i0), bool)
    for c in np.unique(cell):
        idx = np.nonzero(cell == c)[0]
        keep[idx[np.argsort(pdws["toa"][idx], kind="stable")[:slots]]] = True
    return {k: v[keep] for k, v in pdws.items()}


def unsharded_reference(pipe, caps) -> dict:
    """Every pulse of each capture, from the single-device step with slots
    a channel to spare (doubled from the widest mesh's shards times
    ``max_pulses`` until no channel fills them: the dense capture fills a
    channel's 512), which ``shard_slots`` cuts to what a sharded step
    keeps."""
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    out = {}
    for name, samples in caps.items():
        slots = max(nt for nt, _ in SHARD_MESHES) * pipe.pdw_cfg.max_pulses
        while True:
            big = ChannelizerPipeline(pipe.channelizer, dataclasses.replace(
                pipe.pdw_cfg, max_pulses=slots), pipe.device)
            out[name] = big.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
            if np.bincount(out[name]["channel"]).max() < slots:
                break
            slots *= 2
    return out


def pdws_sharded_agree(a: dict, b: dict, where: str) -> None:
    """The sharded = single-device invariant: integer fields and ``mag``
    bit for bit, freq and snr within rtol 1e-9, atol 1e-5 (the bars of
    ``tests/test_parallel_fused.py``)."""
    check(len(a["toa"]) == len(b["toa"]),
          f"{where}: {len(a['toa'])} pulses vs {len(b['toa'])}")
    oa = np.lexsort((a["channel"], a["toa"]))
    ob = np.lexsort((b["channel"], b["toa"]))
    for key in ("toa", "pw", "channel", "sat", "mag"):
        check(np.array_equal(a[key][oa], b[key][ob], equal_nan=True),
              f"{where}: {key} is not bit for bit the single-device step's")
    for key in ("freq", "snr"):
        check(np.allclose(a[key][oa], b[key][ob], rtol=1e-9, atol=1e-5,
                          equal_nan=True), f"{where}: {key} differs")


def sharded_band_checks(xq, pipe) -> dict:
    """K1 and B5 with a band slice against their plain versions and, bit
    for bit, against the full matrix's bands: at the main shape with the
    halves of M = 64, at M = 20 with slices of 10 (and one of 7 from band
    3), and with T one frame either side of a tile boundary (7439, 7440,
    7441 frames, tiles of 15 and 63 frames).  Times K1 and B5 with a half
    beside the full matrix."""
    import torch

    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops import cuda as k

    level = pipe.pdw_cfg.saturation_level
    taps = pipe.channelizer.taps_rev
    m, t_len, p = M_MAIN, FRAMES_MAIN, taps.shape[0]
    out = {"k1": {}, "b5": {}, "cases": []}
    full = k.channelize_streams_packed_cm2(xq, taps, BIT_WIDTH, level)
    flat = k.channelize_streams_packed(xq, taps, BIT_WIDTH, level)
    for band in ((0, m // 2), (m // 2, m // 2)):
        wp, cols = band_parts(m, band), band_cols(band)
        got = k.channelize_streams_packed_cm2(xq, taps, BIT_WIDTH, level,
                                              w_parts=wp)
        torch.cuda.synchronize()
        res = compare_streams(xq, taps, BIT_WIDTH, level, got,
                              f"K1 band {band} main shape", band=band)
        check(all(same(a[cols], b) for a, b in zip(full, got)),
              f"K1 band {band} main shape: not the full kernel's rows")
        out["k1"][f"{band[0]}+{band[1]}"] = res
        got = k.channelize_streams_packed(xq, taps, BIT_WIDTH, level,
                                          w_parts=wp)
        torch.cuda.synchronize()
        res = compare_flat(xq, taps, BIT_WIDTH, level, got,
                           f"B5 band {band} main shape", band=band)
        check(all(same(a[:, cols], b) for a, b in zip(flat, got)),
              f"B5 band {band} main shape: not the full kernel's columns")
        out["b5"][f"{band[0]}+{band[1]}"] = res
        del got
    del full, flat
    half = band_parts(m, (m // 2, m // 2))
    n_w = 4 * p * m + 4 * 4 * m * (m // 2)
    fir, dft = t_len * 4 * p * m, t_len * 8 * m * (m // 2)
    t_bytes = (n_bytes_of(xq) + 3 * 4 * (m // 2) * t_len + n_w) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = (fir / FP32_FLOP_PER_S + 3 * dft / TF32_FLOP_PER_S) * 1e3
    for name, fn in (("k1", k.channelize_streams_packed_cm2),
                     ("b5", k.channelize_streams_packed)):
        out[name]["half_ms"] = time_ms(
            lambda: fn(xq, taps, BIT_WIDTH, level, w_parts=half))
        out[name]["full_ms"] = time_ms(
            lambda: fn(xq, taps, BIT_WIDTH, level))
        out[name]["half_plain_ms"] = time_ms(
            lambda: getattr(k, fn.__name__ + "_plain")(
                xq, taps, BIT_WIDTH, level, w_parts=half), reps=3, warmup=1)
        out[name]["half_bound_ms"] = max(t_bytes, t_ops)
        out[name]["half_bound_by"] = "bytes" if t_bytes >= t_ops \
            else "operations"
        out[name]["shape"] = f"M={m} T={t_len}, bands {m // 2}..{m - 1}"

    dev = xq.device
    for mm, frames, bands in ((20, 777, ((0, 10), (10, 10), (3, 7))),
                              (64, 7439, ((32, 32), (5, 13))),
                              (64, 7440, ((32, 32), (5, 13))),
                              (64, 7441, ((32, 32), (5, 13)))):
        ch_taps = Channelizer.create(mm).taps_rev
        xs = torch.as_tensor(pack(small_capture(mm, frames, 12, seed=mm)),
                             device=dev)
        for ft in (None, 15, 63):
            whole = k.channelize_streams_packed_cm2(xs, ch_taps, 12, level,
                                                    tile_frames=ft)
            wflat = k.channelize_streams_packed(
                xs, ch_taps, 12, level,
                tile_frames=None if ft is None else ft + 1)
            for band in bands:
                where = f"M={mm} T={frames} tile={ft} band={band}"
                wp, cols = band_parts(mm, band), band_cols(band)
                got = k.channelize_streams_packed_cm2(
                    xs, ch_taps, 12, level, tile_frames=ft, w_parts=wp)
                gflat = k.channelize_streams_packed(
                    xs, ch_taps, 12, level, w_parts=wp,
                    tile_frames=None if ft is None else ft + 1)
                torch.cuda.synchronize()
                res = compare_streams(xs, ch_taps, 12, level, got,
                                      "K1 " + where, band=band)
                check(all(same(a[cols], b) for a, b in zip(whole, got)),
                      f"K1 {where}: not the full kernel's rows")
                compare_flat(xs, ch_taps, 12, level, gflat, "B5 " + where,
                             band=band)
                check(all(same(a[:, cols], b) for a, b in zip(wflat, gflat)),
                      f"B5 {where}: not the full kernel's columns")
                out["cases"].append({"case": where, **res})
    return out


def write_dwells(directory: str, samples: np.ndarray, fs: float,
                 bit_width: int, n_files: int = 4) -> None:
    """The (N, 2) integer payload ``samples`` as ``n_files`` contiguous
    ``.iq`` dwell files."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    chunk = len(samples) // n_files
    for k in range(n_files):
        part = samples[k * chunk:(k + 1) * chunk]
        iqpacket.write_iq(os.path.join(directory, f"d{k}.iq"),
                          iqpacket.IqHeader(
                              frequency_hz=0, bandwidth_hz=fs,
                              sample_rate_sps=fs, rx_gain_db=0,
                              num_samples=len(part), bit_width=bit_width,
                              sample_start_time=100.0 + k * chunk / fs),
                          part)


def rows_agree(ranks: list, one: dict, where: str) -> None:
    """The ranks' rows of ``multihost.run_capture_set``, stitched in rank
    order, bit for bit the one-process rows (the floor whole on every
    rank)."""
    for key, want in one.items():
        if key.endswith(("span", "step_ms")):
            continue
        got = ranks[0][key] if key.endswith("nf") else np.concatenate(
            [z[key] for z in ranks])
        check(np.array_equal(got, want, equal_nan=True),
              f"{where}: {key} differs from one process")


def run_module_cli(argv, timeout: float = 600):
    """``python -m sdr_channelizer_tpu_torch <argv>`` in a fresh process."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, "-m", "sdr_channelizer_tpu_torch",
                           *argv], cwd=here, capture_output=True, text=True,
                          timeout=timeout)


def phase_sharded(pipe, caps, rows):
    """This slice's path, ``parallel``: ``ShardedPipeline.extract_fused`` on
    the dense and sparse captures at meshes (4, 1) and (2, 2) of four shards
    on one card, held against the single-device step (launches counted: K1
    and K3 once a shard, K2 once a mesh column); K1's and B5's band slices
    (``sharded_band_checks``); route ``"cm"`` at (2, 2) on the sparse
    capture (B5 with its slice); wideband 16,000,000 samples at (4, 1)
    against ``WidebandPdwPipeline.extract``; ``pdw --shards 4`` through the
    CLI on the card, channelized and wideband, and a ``--strict-halo``
    refusal; two ranks on one card over gloo (the two-process test's
    worker) against the one-process run.  Returns the launches of the
    sharded cm2 steps."""
    import torch

    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.pdw import finalize_pdws
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh
    from sdr_channelizer_tpu_torch.parallel.pipeline import (
        merge_block_batches, sharded_extract_pdws)

    dev = torch.device(DEVICE, 0)
    devices = [dev] * SHARD_DEVICES
    n, fs = M_MAIN * FRAMES_MAIN, FS_MAIN
    profile = "--profile" in sys.argv[1:]
    single = {name: pipe.extract_fused(s, BIT_WIDTH, fs=fs)
              for name, s in caps.items()}
    whole = unsharded_reference(pipe, caps)
    out = {"devices": [str(d) for d in devices]}
    total = {name: 0 for name in SHARDED_COUNTS}

    for nt, nc in SHARD_MESHES:
        key = f"{nt}x{nc}"
        spipe = ShardedPipeline(make_mesh(nt, nc, devices=devices),
                                pipe.channelizer, pipe.pdw_cfg)
        res = {}
        for name, samples in caps.items():
            reset_counts(SHARDED_COUNTS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = spipe.extract_fused(samples, BIT_WIDTH, fs=fs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(SHARDED_COUNTS)
            peak = torch.cuda.max_memory_allocated()
            check(counts["channelize_streams_packed_cm2"] == nt * nc
                  and counts["latch_cumsums_cm"] == nt * nc
                  and counts["noise_floor_cm"] == nc
                  and counts["pulse_stats"] > 0,
                  f"sharded {key} {name}: launch counts {counts}")
            for c in total:
                total[c] += counts[c]
            pdws_sharded_agree(got, shard_slots(
                whole[name], pipe.pdw_cfg.max_pulses, nt),
                f"sharded {key} {name}")
            capped = sum(int(c) == pipe.pdw_cfg.max_pulses
                         for c in np.bincount(single[name]["channel"]))
            xq = torch.as_tensor(pack(samples), device=dev)
            step = time_ms(lambda: spipe.step_packed(xq, BIT_WIDTH), reps=5)
            one = time_ms(lambda: pipe.forward_packed(xq, BIT_WIDTH), reps=5)
            res[name] = {"pulses": len(got["toa"]),
                         "compared_pulses": len(got["toa"]),
                         "unsharded_pulses": len(whole[name]["toa"]),
                         "single_device_pulses": len(single[name]["toa"]),
                         "channels_at_the_slot_cap": capped,
                         "extract_fused_s": wall,
                         "launches": counts, "peak_memory_bytes": peak,
                         "step_ms": step, "single_device_step_ms": one,
                         "msamples_per_s": n / step / 1e3}
            if profile:
                prof = device_times(lambda: spipe.step_packed(xq, BIT_WIDTH),
                                    steps=5)
                busy = sum(r["ms_per_step"] for r in prof)
                res[name].update(device_busy_ms=busy,
                                 idle_share=max(0.0, 1.0 - busy / step),
                                 top_kernels=prof[:8])
            del xq
        # the floor's gather: each column's owned columns into one buffer
        t_loc, m_loc = FRAMES_MAIN // nt, M_MAIN // nc
        parts = [[torch.rand((m_loc, t_loc + HALO_FRAMES), device=dev)
                  for _ in range(nt)] for _ in range(nc)]
        res["gather_ms"] = time_ms(lambda: [
            torch.cat([p[:, :t_loc] for p in col], dim=1) for col in parts])
        res["gather_bound_ms"] = 2 * 4 * M_MAIN * FRAMES_MAIN \
            / HBM_BYTES_PER_S * 1e3
        del parts
        out[key] = res

    xq = torch.as_tensor(pack(caps["dense"]), device=dev)
    bands = sharded_band_checks(xq, pipe)
    del xq
    out["band_slices"] = {k_: v for k_, v in bands.items() if k_ != "cases"}
    out["band_slice_cases"] = len(bands["cases"])

    # route cm at (2, 2) on the sparse capture: B5 with its band slice
    spipe = ShardedPipeline(make_mesh(2, 2, devices=devices),
                            pipe.channelizer, pipe.pdw_cfg)
    xq = torch.as_tensor(pack(caps["sparse"]), device=dev)
    reset_counts(SHARDED_CM_COUNTS)
    _, batch = spipe.step_packed(xq, BIT_WIDTH, route="cm")
    torch.cuda.synchronize()
    counts = read_counts(SHARDED_CM_COUNTS)
    check(counts["channelize_streams_packed"] == 4
          and counts["cm_streams"] == 4 and counts["latch_cumsums"] == 4
          and counts["noise_floor_cm"] == 2
          and counts["pulse_stats_dense"] > 0,
          f"sharded route cm: launch counts {counts}")
    got = spipe._finalize_merged(batch, FRAMES_MAIN // 2, fs, 0.0, 0.0)
    _, _, ref = pipe.forward_packed(xq, BIT_WIDTH, route="flat")
    pdws_sharded_agree(got, pipe._finalize(ref, fs, 0.0, 0.0),
                       "sharded route cm (2, 2) sparse")
    out["route_cm_2x2_sparse"] = {
        "pulses": len(got["toa"]), "launches": counts,
        "step_ms": time_ms(lambda: spipe.step_packed(xq, BIT_WIDTH,
                                                     route="cm"), reps=5),
        "single_device_flat_step_ms": time_ms(
            lambda: pipe.forward_packed(xq, BIT_WIDTH, route="flat"),
            reps=5)}
    del xq, batch

    # wideband, 16,000,000 samples at (4, 1)
    cfg = PdwConfig.wideband(max_pulses=512, max_pulse_samples=4096)
    wpipe = WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg),
                                               DEVICE)
    spec, iq = wideband_capture(WIDE_SAMPLES, 1e-3, 1234, seed=3)
    ref = wpipe.extract(iq, fs=WIDE_FS, sample_start_time=100.0)
    mesh = make_mesh(4, 1, devices=devices)
    x = torch.as_tensor(iq, device=dev)
    reset_counts(SHARDED_WIDE_COUNTS)
    batch, block = sharded_extract_pdws(x, cfg, mesh)
    torch.cuda.synchronize()
    counts = read_counts(SHARDED_WIDE_COUNTS)
    check(counts["noise_floor_cm"] == 1 and counts["cm_streams"] == 4
          and counts["latch_cumsums"] == 4
          and counts["pulse_stats_dense"] > 0,
          f"sharded wideband: launch counts {counts}")
    got = finalize_pdws(merge_block_batches(batch, block), fs=WIDE_FS,
                        sample_start_time=100.0)
    check(len(got["toa"]) > 200, "sharded wideband: too few pulses")
    pdws_sharded_agree(got, ref, "sharded wideband (4, 1)")
    out["wideband_4x1"] = {
        "samples": WIDE_SAMPLES, "pulses": len(got["toa"]),
        "launches": counts,
        "step_ms": time_ms(lambda: sharded_extract_pdws(x, cfg, mesh),
                           reps=3, warmup=1),
        "single_device_step_ms": time_ms(lambda: wpipe.forward(x), reps=3,
                                         warmup=1)}
    del x, batch

    # the CLI on the card, in fresh processes
    with tempfile.TemporaryDirectory() as tmp:
        def write(name, samples, rate):
            path = os.path.join(tmp, name)
            iqpacket.write_iq(path, iqpacket.IqHeader(
                frequency_hz=0.0, bandwidth_hz=rate, sample_rate_sps=rate,
                rx_gain_db=0, num_samples=len(samples), bit_width=BIT_WIDTH,
                sample_start_time=0.0), samples)
            return path

        sparse = write("sparse.iq", caps["sparse"], fs)
        wide_q = quantize(iq)
        wide = write("wide.iq", wide_q, WIDE_FS)
        cli = {}
        a = os.path.join(tmp, "a.npz")
        r = run_module_cli(["pdw", sparse, "--channelized", "--shards", "4",
                            "--max-pulses", "512", "--max-pulse-samples",
                            "1024", "--out", a])
        check(r.returncode == 0 and "(4 shards)" in r.stdout,
              f"cli pdw --channelized --shards 4: rc {r.returncode} "
              f"{r.stderr[-400:]}")
        pdws_sharded_agree(dict(np.load(a)), shard_slots(
            whole["sparse"], pipe.pdw_cfg.max_pulses, 4),
                           "cli pdw --channelized --shards 4")
        cli["channelized_pulses"] = len(np.load(a)["toa"])
        b = os.path.join(tmp, "b.npz")
        r = run_module_cli(["pdw", wide, "--shards", "4", "--max-pulses",
                            "512", "--max-pulse-samples", "4096", "--out", b])
        check(r.returncode == 0, f"cli pdw --shards 4: rc {r.returncode} "
                                 f"{r.stderr[-400:]}")
        wref = wpipe.extract(iqpacket.to_complex(wide_q, BIT_WIDTH),
                             fs=WIDE_FS)
        pdws_sharded_agree(dict(np.load(b)), wref, "cli pdw --shards 4")
        cli["wideband_pulses"] = len(np.load(b)["toa"])
        r = run_module_cli(["pdw", sparse, "--channelized", "--shards", "4",
                            "--strict-halo", "--max-pulse-samples", "100000",
                            "--out", os.path.join(tmp, "c.npz")])
        check(r.returncode != 0 and "halo" in r.stderr
              and not os.path.exists(os.path.join(tmp, "c.npz")),
              f"cli --strict-halo did not refuse: rc {r.returncode}")
        cli["strict_halo_refused"] = True
        out["cli"] = cli

    # two ranks on one card over gloo, the exchanges staged through the
    # host: the small capture of tests/test_torch_multihost.py
    from sdr_channelizer_tpu_torch.parallel import multihost
    from sdr_channelizer_tpu_torch.signal.synth import (PulseTrainSpec,
                                                         pulse_train)

    spec = PulseTrainSpec(sample_rate_sps=8e6, duration_sec=8e-3,
                          frequency_hz=1.9e6, pulse_width_sec=80e-6,
                          pri_sec=310e-6, start_index=333, noise_std=2e-3)
    job = {"channels": 8, "pdw": dataclasses.asdict(PdwConfig.channelized(
        max_pulses=32, max_pulse_samples=64)), "halo_frames": 64,
        "halo_mode": "strict",
        "runs": [{"name": "", "mesh": [8, 1], "step": "step"},
                 {"name": "cm2_", "mesh": [4, 2], "step": "packed",
                  "route": "cm2"}]}
    with tempfile.TemporaryDirectory() as tmp:
        write_dwells(tmp, iqpacket.from_complex(pulse_train(spec, seed=11),
                                                16), 8e6, 16)
        t0 = time.perf_counter()
        ranks = multihost.launch_ranks(tmp, job, [[dev] * 4] * 2,
                                       backend="gloo", timeout=300)
        wall = time.perf_counter() - t0
        one = multihost.run_capture_set(tmp, [dev] * 8, job)
        rows_agree(ranks, one, "two ranks on one card")
        out["two_ranks"] = {"device": str(dev), "backend": "gloo",
                            "wall_s": wall, "equal_to_one_process": True,
                            "pulses": int(one["count"].sum()),
                            "cm2_pulses": int(one["cm2_count"].sum())}

    # the kernels line: the sharded steps' launches, and the band slice's
    # readings on K1's and B5's rows
    sharded = dict(total, channelize_streams_packed=out[
        "route_cm_2x2_sparse"]["launches"]["channelize_streams_packed"])
    for r in rows:
        if r["name"] in sharded:
            r["sharded_launches"] = sharded[r["name"]]
        key = {"channelize_streams_packed_cm2": "k1",
               "channelize_streams_packed": "b5"}.get(r["name"])
        if key:
            b = bands[key]
            r["w_parts"] = {"ms": b["half_ms"], "plain_ms": b["half_plain_ms"],
                            "bound_ms": b["half_bound_ms"],
                            "bound_by": b["half_bound_by"],
                            "full_ms": b["full_ms"], "shape": b["shape"]}
    emit("sharded", **out)
    return total


def host_ms(fn, devices, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` over ``reps`` runs after one, every
    device synchronised (one card's events do not see the others)."""
    import torch

    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)

    fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_cards(pipe, caps):
    """The sharded path where each shard has a card of its own; on a
    machine with one card, a line that says so.  One process with a mesh
    over every card, (n, 1) and with four (2, 2): ``extract_fused`` of the
    sparse and dense captures against the unsharded step
    (``shard_slots``), its step's time beside the single-device step's.
    Then one process a card joined by NCCL (the FIR tails, the halo heads,
    the latch transfers and the floor's inputs cross cards through it),
    each reading its own span of the sparse capture written as four dwell
    files: the packed step at (n, 1) bit for bit the one-process rows."""
    import torch

    from sdr_channelizer_tpu_torch.parallel import (ShardedPipeline,
                                                    make_mesh, multihost)

    n = torch.cuda.device_count()
    if n < 2:
        emit("cards", skipped=f"needs at least two CUDA devices, have {n}")
        return
    devices = [torch.device(DEVICE, i) for i in range(n)]
    whole = unsharded_reference(pipe, caps)
    out = {"devices": [str(d) for d in devices]}
    for nt, nc in [(n, 1)] + ([(2, 2)] if n == 4 else []):
        spipe = ShardedPipeline(make_mesh(nt, nc, devices=devices),
                                pipe.channelizer, pipe.pdw_cfg)
        res = {}
        for name, samples in caps.items():
            reset_counts(SHARDED_COUNTS)
            got = spipe.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
            counts = read_counts(SHARDED_COUNTS)
            check(counts["channelize_streams_packed_cm2"] == nt * nc
                  and counts["latch_cumsums_cm"] == nt * nc,
                  f"{nt}x{nc} on {n} cards {name}: launch counts {counts}")
            pdws_sharded_agree(got, shard_slots(
                whole[name], pipe.pdw_cfg.max_pulses, nt),
                f"{nt}x{nc} on {n} cards, {name}")
            xq = torch.as_tensor(pack(samples), device=devices[0])
            res[name] = {
                "pulses": len(got["toa"]), "launches": counts,
                "step_ms": host_ms(lambda: spipe.step_packed(xq, BIT_WIDTH),
                                   devices),
                "single_device_step_ms": host_ms(
                    lambda: pipe.forward_packed(xq, BIT_WIDTH), devices[:1])}
            del xq
        out[f"{nt}x{nc}"] = res

    job = {"channels": M_MAIN, "pdw": dataclasses.asdict(pipe.pdw_cfg),
           "reps": 5, "runs": [{"name": "", "mesh": [n, 1],
                                "step": "packed"}]}
    with tempfile.TemporaryDirectory() as tmp:
        write_dwells(tmp, caps["sparse"], FS_MAIN, BIT_WIDTH)
        t0 = time.perf_counter()
        ranks = multihost.launch_ranks(tmp, job, [[d] for d in devices],
                                       backend="nccl", timeout=600)
        wall = time.perf_counter() - t0
        one = multihost.run_capture_set(tmp, devices, job)
    rows_agree(ranks, one, f"{n} NCCL processes")
    out["processes"] = {"world": n, "backend": "nccl", "wall_s": wall,
                        "equal_to_one_process": True,
                        "pulses": int(one["count"].sum()),
                        "step_ms": [float(z["step_ms"]) for z in ranks],
                        "one_process_step_ms": float(one["step_ms"])}
    emit("cards", **out)


def main_pipe():
    """The main path's pipeline: M = 64, ``PdwConfig.channelized(512,
    1024)``, on the card."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    return ChannelizerPipeline.create(
        M_MAIN, device=DEVICE,
        pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024))


def main_captures() -> dict:
    """The sparse and dense captures of M_MAIN * FRAMES_MAIN samples."""
    n = M_MAIN * FRAMES_MAIN
    return {"sparse": quantize(make_capture(n, M_MAIN, sparse=True)),
            "dense": quantize(make_capture(n, M_MAIN, sparse=False))}


def cards_main() -> int:
    """The multi-card phase alone, for a machine with several cards:
    ``python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.cards_main())'``.
    Exits 2 with fewer than two CUDA devices."""
    import torch

    if torch.cuda.device_count() < 2:
        print("chip_smoke: the cards phase needs at least two CUDA devices",
              file=sys.stderr)
        return 2
    try:
        card = phase_env()
        phase_build()
        phase_cards(main_pipe(), main_captures())
    except SmokeFailure as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_track():
    """The closed loop on the card: ``EventTracker`` on
    ``DeviceDwellEmitter`` in the dense scene, 20 dwells of 80 ms at 56
    Msps; the step timed on the host clock with a CUDA sync; the scan period
    recovered; one dwell's event core on the card against the CPU."""
    import torch

    from sdr_channelizer_tpu_torch.capture import (
        DeviceDwellEmitter, EventTracker)
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod

    def tracker():
        return EventTracker(radio=DeviceDwellEmitter(
            sample_rate_sps=EVENT_FS, **DENSE_SCENE, device=DEVICE),
            dwell_sec=DWELL_SEC, device=DEVICE)

    tracker().run(2)  # warm-up: allocator, first launches
    tr = tracker()
    steps, reports = [], []
    for _ in range(TRACK_DWELLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports.append(tr.step())
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    ev = np.asarray(tr.events)
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
    p50, p95 = np.percentile(steps, [50, 95])
    emit("track", dwells=TRACK_DWELLS, dwell_ms=DWELL_SEC * 1e3,
         samples=TRACK_DWELLS * n, fs=EVENT_FS, scene="dense",
         step_ms_p50=float(p50), step_ms_p95=float(p95), step_ms=steps,
         pulses=[r.num_pulses for r in reports], events=ev.tolist(),
         median_phase_err_s=float(np.median(err)),
         core_card_equals_cpu=True, core_pulses=int(a.count),
         core_mag_max_rel_err=float(np.max(np.abs(a.mag - b.mag)
                                           / np.maximum(np.abs(b.mag), 1e-30))),
         counters=tr.counters.snapshot()["counters"])


def profile_step(label: str, fn, steps: int = 5) -> None:
    """Device time by kernel name over a few calls of ``fn``, from
    ``torch.profiler``, as one ``profile`` line."""
    rows = device_times(fn, steps)
    busy = sum(r["ms_per_step"] for r in rows)
    emit("profile", capture=label, steps=steps,
         device_busy_ms_per_step=busy, kernels=rows[:14],
         rest_ms_per_step=sum(r["ms_per_step"] for r in rows[14:]),
         pulse_stats_ms_per_step=sum(r["ms_per_step"] for r in rows
                                     if "pulse_stats" in r["kernel"]))


def phase_profile(pipe, caps, rows):
    """Only with ``--profile``: device time by kernel name over a few steps
    of the main path on both captures, of the flat and cm routes and the
    complex form on the dense one, of the wideband step and of one
    ``predict`` dwell's step; then each statistics row's call alone, its
    kernels' time as the row's ``profile_ms``."""
    import torch

    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
    from sdr_channelizer_tpu_torch.ops import cuda as k

    for name, samples in caps.items():
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        profile_step(name, lambda: pipe.forward_packed(xq, BIT_WIDTH))
        if name == "dense":
            for route in ("flat", "cm"):
                profile_step(f"{name}, route {route}",
                             lambda: pipe.forward_packed(xq, BIT_WIDTH,
                                                         route=route))
        del xq
    x = torch.as_tensor(iqpacket.to_complex(caps["dense"], BIT_WIDTH),
                        device=pipe.device)
    profile_step("dense, channelize_complex", lambda: k.channelize_complex(
        x, pipe.channelizer.taps_rev))
    del x
    wide = WidebandPdwPipeline(PdwConfig.wideband(
        max_pulses=512, max_pulse_samples=4096), DEVICE)
    x = torch.as_tensor(wideband_capture(WIDE_SAMPLES, 1e-3, 1234, seed=3)[1],
                        device=DEVICE)
    profile_step("wideband, 16,000,000 samples", lambda: wide.forward(x),
                 steps=3)
    del x
    # one predict dwell: the scanning beam at its peak, predict's window
    from sdr_channelizer_tpu_torch.capture import DeviceDwellEmitter

    (xr, xi), _ = DeviceDwellEmitter(sample_rate_sps=EVENT_FS, **SCAN,
                                     device=DEVICE).receive(
        int(round(DWELL_SEC * EVENT_FS)), start_time=0.06)
    event = WidebandPdwPipeline(PdwConfig.event(
        max_pulses=512, max_pulse_samples=PREDICT_WINDOW), DEVICE)
    xc = torch.complex(xr, xi)
    profile_step("predict dwell, 4,480,000 samples",
                 lambda: event.forward(xc))
    # each statistics row's call alone: its kernels' device time, last, as
    # many short traces in a row may drop events from later ones
    for r in rows:
        if r["name"] in STATS_CALLS:
            r["profile_ms"] = sum(
                t["ms_per_step"] for t in device_times(STATS_CALLS[r["name"]], 5)
                if "pulse_stats" in t["kernel"] or "live_tiles" in t["kernel"])


def phase_profile_streaming(pipe, caps):
    """Only with ``--profile``: where a streamed block's time goes.  One
    file of the sparse capture (4 blocks); the steps of block 1 of the
    detect pass one by one on the host clock, each ended by a device
    synchronise (median of 5); then the device time by kernel name over one
    whole ``extract_segment_fused``, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.dsp import streaming
    from sdr_channelizer_tpu_torch.ops import cuda as k

    fs = M_MAIN * 1e6
    cfg = pipe.pdw_cfg
    chan = pipe.channelizer
    m, p = chan.num_bands, chan.taps_per_band
    dev = pipe.device

    def clock(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), res

    with tempfile.TemporaryDirectory() as tmp:
        write_segment(tmp, [caps["sparse"]], fs, 0.0)
        seg = streaming.CaptureSet.from_dir(tmp).segments[0]
        ext = streaming.StreamingExtractor(chan, cfg, block_frames=BLOCK_FRAMES,
                                           device=DEVICE)
        f0, t_k, h_k = BLOCK_FRAMES, BLOCK_FRAMES, HALO_FRAMES
        steps = {}
        def read():
            return seg.read_samples_raw((f0 - (p - 1)) * m,
                                        (p - 1 + t_k + h_k) * m)

        # the path copies straight from the file's mapped pages; read alone
        # (a host copy out of the page cache) and the copy alone (from that
        # pageable array) are timed beside it
        steps["read_and_h2d_ms"], _ = clock(lambda: torch.as_tensor(
            streaming._packed_view(read())).to(dev))
        steps["read_ms"], raw = clock(lambda: np.array(read()))
        packed = streaming._packed_view(raw)
        steps["h2d_ms"], xq = clock(lambda: torch.as_tensor(packed).to(dev))
        hist, blk = xq[: (p - 1) * m], xq[(p - 1) * m:]
        steps["channelize_cm_ms"], cm = clock(
            lambda: k.channelize_streams_packed_cm(
                blk, chan.taps_rev, BIT_WIDTH, cfg.saturation_level,
                history=hist))
        mag, mag_cm, dph_cm, sat_cm = cm
        nf = k.noise_floor_cm(mag_cm, t_k + h_k)
        entry = torch.zeros(m, dtype=torch.bool, device=dev)
        lead = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
        steps["latch_ms"], _ = clock(
            lambda: k.latch_cumsums(mag, lead, lead, entry.float()))
        steps["tail_ms"], batch = clock(
            lambda: pdwmod._extract_channelized_pallas_stats(
                mag, None, None, cfg, nf, entry_active=entry, own_len=t_k,
                cm_streams=(mag_cm, dph_cm, sat_cm)))
        steps["block_transfer_ms"], _ = clock(
            lambda: pdwmod.block_transfer(
                mag_cm[:, :t_k], nf[:, None], cfg.snr_threshold_db,
                cfg.trailing_threshold_db))
        steps["batch_d2h_ms"], host = clock(
            lambda: pdwmod.batch_to_host(batch))
        path = os.path.join(tmp, "block.npz")
        steps["npz_write_ms"], _ = clock(lambda: np.savez(
            path, a=np.zeros(m, bool), b=np.ones(m, bool),
            **{f.name: getattr(host, f.name)
               for f in dataclasses.fields(pdwmod.PdwBatch)}))
        # "tail" is the whole block tail: latch, search, statistics, masks
        steps["search_stats_rest_ms"] = steps["tail_ms"] - steps["latch_ms"]

        ext.extract_segment_fused(seg)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ext.extract_segment_fused(seg)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        is_kernel = getattr(ev, "device_type", None) is not None and \
            "cuda" in str(ev.device_type).lower()
        if is_kernel and dev_us > 0:
            rows.append({"kernel": ev.key[:80], "calls": ev.count,
                         "ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    emit("profile_streaming", capture="sparse, one file, 4 blocks",
         block_steps_ms=steps, run_wall_ms_under_profiler=wall_ms,
         device_busy_ms=busy, kernels=rows[:14],
         rest_ms=sum(r["ms"] for r in rows[14:]))


def have(lib: str) -> bool:
    """Whether ``lib`` is installed (the views' libraries are optional)."""
    import importlib.util

    return importlib.util.find_spec(lib) is not None


def run_cli(argv) -> list:
    """``python -m sdr_channelizer_tpu_torch <argv>`` in this process; the
    paths and lines it printed.  Fails on a non-zero exit."""
    from sdr_channelizer_tpu_torch.cli.main import main

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = main(argv)
    check(rc == 0, f"cli {' '.join(argv[:2])}: exit code {rc}")
    return said.getvalue().splitlines()


def spectrogram_f64(iq: np.ndarray, length: int) -> np.ndarray:
    """The spectrogram's float64 oracle: the same Hamming-windowed frames,
    FFT, ``fftshift``, |.|^2."""
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(length) / (length - 1))
    frames = iq[: len(iq) // length * length].reshape(-1, length)
    spec = np.fft.fft(frames.astype(np.complex128) * w, axis=-1)
    return np.abs(np.fft.fftshift(spec, axes=-1)) ** 2


def phase_ingest_views(pipe, caps):
    """Every capture container at the main path's size, the spectrogram and
    ``channelize`` on the card.

    The sparse capture (M = 64 x 262144 frames, int16, bit width 12) is
    written as ``.iq`` and converted by the CLI to a raw ``.npz``, a raw v5
    ``.mat``, a normalised ``.npz`` and, with ``h5py``, a raw v7.3 ``.mat``;
    each raw payload goes through ``extract_fused`` (K1 once each, PDWs bit
    for bit the ``.iq`` run's), the normalised one through ``extract``.
    The wideband 16M capture at bit width 12 goes packed through
    ``stft_power_packed``, held against a float64 STFT and ``stft_power``;
    ``channelize`` runs B9 once a file, and ``waterfall_window_pngs`` once
    a window (its renderer replaced by a recorder, so that it runs without
    ``matplotlib``; each |y| held against the plain version).  The launches
    counted here go on this phase's line, not on the kernels line."""
    import torch

    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.dsp.spectrogram import (
        _windowed_dft_power_planes, hamming, stft_power, stft_power_packed)
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.io.convert import (
        load_capture, load_capture_raw)
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
    from sdr_channelizer_tpu_torch.viz import plots

    fs = M_MAIN * 1e6
    samples = caps["sparse"]
    skipped = []
    # this phase's own counts; the kernels line reads the main path's
    launches = {"channelize_streams_packed_cm2": {}, "channelize_complex": 0}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "sparse.iq")
        iqpacket.write_iq(src, iqpacket.IqHeader(
            frequency_hz=0.0, bandwidth_hz=fs, sample_rate_sps=fs,
            rx_gain_db=0.0, num_samples=len(samples), bit_width=BIT_WIDTH,
            sample_start_time=0.0), samples)
        paths = {"iq": src}
        conversions = [("npz_raw", ["--raw"]), ("mat_raw", ["--mat", "--raw"]),
                       ("npz", [])]
        if have("h5py"):
            conversions.append(("mat73_raw", ["--mat", "--v73", "--raw"]))
        else:
            skipped.append({"step": "convert --mat --v73 --raw (main size)",
                            "missing": "h5py"})
        convert_s = {}
        for kind, flags in conversions:
            t0 = time.perf_counter()
            paths[kind] = run_cli(["convert", src, "--out-dir",
                                   os.path.join(tmp, kind)] + flags)[-1]
            convert_s[kind] = time.perf_counter() - t0

        # the raw containers: the main path, K1 once each, the .iq's PDWs
        containers, ref = {}, None
        for kind in ("iq", "npz_raw", "mat_raw", "mat73_raw"):
            if kind not in paths:
                continue
            t0 = time.perf_counter()
            raw, bw, meta = load_capture_raw(paths[kind])
            load_s = time.perf_counter() - t0
            check(raw is not None and raw.dtype == np.int16
                  and bw == BIT_WIDTH and np.array_equal(raw, samples),
                  f"{kind}: the raw payload is not the .iq payload")
            ck.launches = 0
            got = pipe.extract_fused(raw, bw, fs=float(meta["fs"]))
            check(ck.launches == 1, f"{kind}: K1 launched {ck.launches} "
                                    f"times, not once")
            launches["channelize_streams_packed_cm2"][kind] = ck.launches
            if ref is None:
                ref = got
            else:
                pdws_identical(got, ref, f"{kind} container vs the .iq file")
            containers[kind] = {"load_s": load_s,
                                "bytes": os.path.getsize(paths[kind]),
                                "pulses": len(got["toa"]),
                                "equals_iq_bit_for_bit": True}
        # the normalised container: extract, the cm2 form on float planes
        t0 = time.perf_counter()
        iq, meta = load_capture(paths["npz"])
        load_s = time.perf_counter() - t0
        ck.launches = 0
        got = pipe.extract(iq, fs=float(meta["fs"]))
        check(ck.launches == 1, "normalised .npz: the cm2 form on float "
                                "planes was not launched once")
        launches["channelize_streams_packed_cm2"]["npz"] = ck.launches
        pdws_agree(got, ref, "normalised .npz container vs the .iq file")
        containers["npz"] = {"load_s": load_s,
                             "bytes": os.path.getsize(paths["npz"]),
                             "pulses": len(got["toa"])}
        for kind, sec in convert_s.items():
            containers[kind]["convert_s"] = sec
        out["containers"] = containers

        # channelize on the card: B9 once a file, chan_iq held against the
        # kernel's plain version on the same planes
        chan = Channelizer.create(M_MAIN)
        deq = iqpacket.to_complex(samples, BIT_WIDTH)
        xr = torch.as_tensor(np.ascontiguousarray(deq.real), device=DEVICE)
        xi = torch.as_tensor(np.ascontiguousarray(deq.imag), device=DEVICE)
        want = ck.channelize_complex_planes_plain(xr, xi, chan.taps_rev)
        del xr, xi
        chan_out, chan_s, y_ref = {}, {}, None
        for kind in ("iq", "npz_raw", "mat_raw"):
            npz = os.path.join(tmp, f"chan_{kind}.npz")
            ck.launches_complex = 0
            t0 = time.perf_counter()
            run_cli(["channelize", paths[kind], "--out", npz])
            chan_s[kind] = time.perf_counter() - t0
            check(ck.launches_complex == 1, f"channelize {kind}: B9 launched "
                                            f"{ck.launches_complex} times")
            launches["channelize_complex"] += ck.launches_complex
            y = np.load(npz)["chan_iq"]
            check(y.shape == (FRAMES_MAIN, M_MAIN),
                  f"channelize {kind}: chan_iq of shape {y.shape}")
            if y_ref is None:
                y_ref = y
                yt = torch.as_tensor(y, device=DEVICE).to(torch.complex64)
                check(bool(torch.isfinite(yt).all()), "channelize: non-finite "
                                                     "chan_iq")
                err = float((yt - want).abs().max())
                check(bool(torch.allclose(yt, want, rtol=MAG_TOL,
                                          atol=MAG_TOL)),
                      f"channelize: chan_iq differs from the plain version "
                      f"(max |d| {err})")
                del yt
            else:
                check(np.array_equal(y, y_ref), f"channelize {kind}: chan_iq "
                                                "differs from the .iq file's")
        del want
        # the waterfall's windows on the card, whatever is installed: the
        # renderer replaced by a recorder, B9 once a window, each |y| held
        # against |plain| on the window's planes
        seen = []
        real_png = plots.waterfall_png
        plots.waterfall_png = lambda p, y, *a, **k: seen.append(y)
        try:
            ck.launches_complex = 0
            t0 = time.perf_counter()
            plots.waterfall_window_pngs(os.path.join(tmp, "windows"), deq, fs,
                                        M_MAIN, limit=4, device=DEVICE)
            chan_s["windows"] = time.perf_counter() - t0
        finally:
            plots.waterfall_png = real_png
        check(len(seen) == 4 and ck.launches_complex == 4,
              f"waterfall windows: {len(seen)} windows, B9 launched "
              f"{ck.launches_complex} times")
        launches["channelize_complex_windows"] = ck.launches_complex
        win = int(5e-3 * fs) // M_MAIN * M_MAIN
        win_err = 0.0
        for k, y in enumerate(seen):
            w = deq[k * 100 * M_MAIN: k * 100 * M_MAIN + win]
            pw = ck.channelize_complex_planes_plain(
                torch.as_tensor(np.ascontiguousarray(w.real), device=DEVICE),
                torch.as_tensor(np.ascontiguousarray(w.imag), device=DEVICE),
                chan.taps_rev)
            pm = torch.sqrt(pw.real * pw.real + pw.imag * pw.imag)
            yt = torch.as_tensor(y, device=DEVICE)
            check(yt.shape == pm.shape and bool(torch.isfinite(yt).all()),
                  f"waterfall window {k}: |y| of shape {tuple(yt.shape)}")
            win_err = max(win_err, float((yt - pm).abs().max()))
            check(bool(torch.allclose(yt, pm, rtol=MAG_TOL, atol=MAG_TOL)),
                  f"waterfall window {k}: |y| differs from |plain| "
                  f"(max |d| {win_err})")
        frames = 0
        if have("matplotlib"):
            fr_dir = os.path.join(tmp, "frames")
            argv = ["channelize", src, "--out", os.path.join(tmp, "c.npz"),
                    "--frames-dir", fr_dir, "--frame-limit", "4"]
            video = have("cv2") or shutil.which("ffmpeg") is not None
            if video:
                argv += ["--video", os.path.join(tmp, "waterfall.mp4")]
            else:
                skipped.append({"step": "channelize --video",
                                "missing": "cv2 and ffmpeg"})
            ck.launches_complex = 0
            t0 = time.perf_counter()
            printed = run_cli(argv)
            chan_s["frames"] = time.perf_counter() - t0
            frames = sum(p.endswith(".png") for p in printed)
            check(frames == 4 and ck.launches_complex == 1 + frames,
                  f"channelize --frames-dir: {frames} frames, B9 launched "
                  f"{ck.launches_complex} times")
            launches["channelize_frames_dir"] = ck.launches_complex
            check(not video or os.path.getsize(printed[-1]) > 0,
                  "channelize --video: no video")
        else:
            skipped.append({"step": "channelize --frames-dir / --video",
                            "missing": "matplotlib"})
        out["channelize"] = {
            "files": 3, "windows": len(seen), "frames": frames,
            "wall_s": chan_s, "max_abs_err_vs_plain": err,
            "windows_max_abs_err_vs_plain": win_err}
        del y_ref, deq

    # the spectrogram: 16,000,000 samples at bit width 12, window 768
    _, wiq = wideband_capture(WIDE_SAMPLES, 1e-3, 1234, seed=3)
    wsamples = quantize(wiq)
    del wiq
    length = 768
    n_frames = WIDE_SAMPLES // length
    xq = torch.as_tensor(pack(wsamples), device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    power = stft_power_packed(xq, BIT_WIDTH, device=DEVICE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0   # the DFT matrix built on the host
    peak = torch.cuda.max_memory_allocated() - base
    check(power.shape == (n_frames, length) and power.dtype == torch.float32
          and bool(torch.isfinite(power).all()),
          f"spectrogram: {tuple(power.shape)} {power.dtype}")
    deq = iqpacket.to_complex(wsamples, BIT_WIDTH)
    oracle = spectrogram_f64(deq, length)
    top = float(oracle.max())
    err64 = float(np.abs(power.cpu().numpy() - oracle).max()) / top
    del oracle
    check(err64 <= SPEC_TOL, f"spectrogram: {err64} of the largest power "
                             f"from the float64 STFT")
    xc = torch.as_tensor(deq, device=DEVICE)
    del deq
    as_float = stft_power(xc, device=DEVICE)
    err_float = max_abs(power, as_float) / top
    check(err_float <= SPEC_TOL, f"spectrogram: {err_float} of the largest "
                                 f"power from stft_power")
    err_fft = max_abs(stft_power(xc, method="fft", device=DEVICE), power) / top
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        stft_power_packed(xq[: 4 * length], BIT_WIDTH, device=DEVICE)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "spectrogram: TF32 products were not refused")
    ms = time_ms(lambda: stft_power_packed(xq, BIT_WIDTH, device=DEVICE))
    fft_ms = time_ms(lambda: stft_power(xc, method="fft", device=DEVICE))
    # where the time goes: the unpacking, then the products and |.|^2
    framed = xq[: n_frames * length].reshape(n_frames, length)
    unpack_ms = time_ms(lambda: ck.unpack_pairs(framed))
    i, q = ck.unpack_pairs(framed)
    xr, xi = i * 2.0 ** -(BIT_WIDTH - 1), q * 2.0 ** -(BIT_WIDTH - 1)
    del i, q
    window = hamming(length)
    products_ms = time_ms(lambda: _windowed_dft_power_planes(xr, xi, length,
                                                             window))
    del xr, xi, framed
    n_flop = 8 * n_frames * length * length   # four (F, L) x (L, L) products
    n_bytes = xq.numel() * 4 + power.numel() * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / FP32_FLOP_PER_S * 1e3
    out["spectrogram"] = {
        "samples": WIDE_SAMPLES, "window": length, "frames": n_frames,
        "bit_width": BIT_WIDTH, "max_err_vs_float64_of_peak": err64,
        "max_err_vs_stft_power_of_peak": err_float,
        "equals_stft_power_bit_for_bit": same(power, as_float),
        "cufft_form_max_err_of_peak": err_fft, "tf32_refused": True,
        "ms": ms, "first_call_s": first_s, "unpack_ms": unpack_ms,
        "products_ms": products_ms, "cufft_form_ms": fft_ms,
        "bound_ms": max(t_bytes, t_flop),
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
        # the same function by an FFT: about 5 L log2 L operations a frame
        "fft_form_bound_ms": max(t_bytes, 5 * n_frames * length
                                 * np.log2(length) / FP32_FLOP_PER_S * 1e3),
        "gflop": n_flop / 1e9, "peak_memory_bytes": peak}
    del xq, xc, power, as_float
    torch.cuda.empty_cache()
    emit("ingest_views", bands=M_MAIN, frames=FRAMES_MAIN,
         launches=launches, skipped=skipped, **out)
    return skipped


BENCH_COUNTS = {
    "channelize_streams_packed_cm2": "channelizer_kernel.launches",
    "noise_floor_cm": "nf_kernel.launches",
    "latch_cumsums_cm": "latch_kernel.launches",
    "pulse_stats": "pulse_stats_kernel.launches"}
STAGE_COUNTS = {
    "channelize_streams (B5)": "channelizer_kernel.launches_flat",
    "cm_streams (B8)": "transpose_kernel.launches",
    "latch_cumsums (B7)": "latch_kernel.launches_tm",
    "pulse_stats_dense (K4)": "pulse_stats_kernel.launches_dense"}
BENCH_STAGE_LINE = r"^bench: (\S+)\s+([0-9.]+) Msps  \(([0-9.]+) ms\)$"


def run_bench(fn, argv) -> tuple:
    """``fn(argv)`` in this process with its output caught: its one JSON
    line on stdout and its standard error.  Fails on a non-zero exit."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    check(rc == 0, f"{fn.__module__} {' '.join(argv)}: exit code {rc}")
    return [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue()


def bench_line_ok(line: dict, where: str) -> None:
    """A ``bench`` JSON line: the keys of the JAX package's ``bench.py``
    plus the port's, every reading finite and positive, the card named."""
    import torch

    keys = {"metric", "value", "unit", "vs_baseline", "latency_p50_ms",
            "dense_pulses_per_step", "sparse_msps", "sparse_pulses_per_step",
            "protocol", "rep_spread_pct", "ingest", "device",
            "device_step_ms", "power_limit_w"}
    check(set(line) == keys, f"{where}: keys {sorted(line)}")
    check(line["metric"] == "channelize_pdw_throughput"
          and line["unit"] == "Msamples/s/card", f"{where}: metric / unit")
    check(line["device"] == f"cuda:{torch.cuda.get_device_name(0)}",
          f"{where}: device {line['device']!r}")
    for key in ("value", "vs_baseline", "latency_p50_ms", "sparse_msps",
                "device_step_ms", "power_limit_w", "dense_pulses_per_step",
                "sparse_pulses_per_step"):
        v = line[key]
        check(v is not None and np.isfinite(v) and v > 0,
              f"{where}: {key} = {v}")
    check(np.isfinite(line["rep_spread_pct"]) and line["rep_spread_pct"] >= 0,
          f"{where}: rep_spread_pct = {line['rep_spread_pct']}")
    check(line["device_step_ms"] <= 1.1 * line["latency_p50_ms"],
          f"{where}: the graph's step {line['device_step_ms']} ms over 1.1 x "
          f"the events' {line['latency_p50_ms']} ms")


def phase_bench(pipe, caps):
    """The benchmark harness (``sdr_channelizer_tpu_torch.bench``) at its
    full size, M = 64 x 262144 frames, in this process: the headline (K1,
    K2 and K3 once a step, K4 twice, counted), its dense and sparse pulse
    counts against one ``forward_packed`` step of this run on the same
    capture; ``--stages`` (B5, B8, B7 and K4 counted) and ``--planes``;
    ``bench`` through the CLI in a fresh process; ``bench_scaling --fused``
    at the sizes the cards give (size 1 on one card)."""
    import torch

    from sdr_channelizer_tpu_torch import bench, bench_scaling

    t0 = time.perf_counter()
    ref = {}
    for name, samples in caps.items():
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        ref[name] = int(pipe.forward_packed(xq, BIT_WIDTH)[2].count.sum())
        del xq
    reset_counts(BENCH_COUNTS)
    (head,), err = run_bench(bench.main, [])
    launches = read_counts(BENCH_COUNTS)
    bench_line_ok(head, "bench")
    host = re.search(r"^bench: host launches a dense step in ([0-9.]+) ms",
                     err, re.M)
    check(host is not None, "bench: no line of the host's launch time")
    for name in ("dense", "sparse"):
        got = head[f"{name}_pulses_per_step"]
        check(got == ref[name], f"bench: {got} {name} pulses a step, "
                                f"forward_packed {ref[name]}")
    steps = launches["channelize_streams_packed_cm2"]
    check(steps >= 2 * 120 * 5, f"bench: K1 launched {steps} times")
    check(launches["noise_floor_cm"] == launches["latch_cumsums_cm"] == steps
          and launches["pulse_stats"] == 2 * steps,
          f"bench: launches {launches}, not K1-K3 once a step, K4 twice")

    reset_counts(STAGE_COUNTS)
    (staged,), err = run_bench(bench.main, ["--stages", "--rounds", "3"])
    stage_launches = read_counts(STAGE_COUNTS)
    bench_line_ok(staged, "bench --stages")
    stages = {m[0]: {"msamples_per_s": float(m[1]), "ms": float(m[2])}
              for m in re.findall(BENCH_STAGE_LINE, err, re.M)}
    check(list(stages) == ["streams_kernel", "noise_floor", "pdw_extract"],
          f"bench --stages: stage lines {list(stages)}")
    check(all(v > 0 for v in stage_launches.values()),
          f"bench --stages: launches {stage_launches}")

    (planes,), _ = run_bench(bench.main, ["--planes", "--rounds", "3"])
    bench_line_ok(planes, "bench --planes")
    check(planes["ingest"] == "f32_planes"
          and planes["dense_pulses_per_step"] == ref["dense"]
          and planes["sparse_pulses_per_step"] == ref["sparse"],
          f"bench --planes: {planes['dense_pulses_per_step']} / "
          f"{planes['sparse_pulses_per_step']} pulses, packed {ref}")

    t_cli = time.perf_counter()
    res = run_module_cli(["bench", "--", "--iters", "20", "--rounds", "2"])
    check(res.returncode == 0, f"cli bench: exit {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 1, f"cli bench: {len(lines)} lines on stdout")
    cli = json.loads(lines[0])
    bench_line_ok(cli, "cli bench")
    check(cli["dense_pulses_per_step"] == ref["dense"],
          f"cli bench: {cli['dense_pulses_per_step']} dense pulses")
    cli_s = time.perf_counter() - t_cli

    scaling, _ = run_bench(bench_scaling.main, ["--fused"])
    check(scaling and scaling[0]["devices"] == 1
          and scaling[0]["mesh"] == "1x1" and scaling[0]["value"] > 0,
          f"bench_scaling --fused: {scaling}")
    emit("bench", headline=head, host_launch_ms=float(host.group(1)),
         launches=launches, forward_packed_pulses=ref,
         stages=stages, stage_launches=stage_launches,
         stages_headline_ms=staged["latency_p50_ms"],
         planes=planes, cli=cli, cli_s=cli_s, scaling_fused=scaling,
         wall_s=time.perf_counter() - t0)


def phase_cli():
    """A synthetic ``.iq`` file through ``pdw --channelized`` on the card,
    then the same samples as two files through ``pdw --stream``, then
    through ``pdw`` without ``--channelized`` (wideband)."""
    from sdr_channelizer_tpu_torch.cli.main import main
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec, pulse_starts, write_training_iq)

    spec = PulseTrainSpec(sample_rate_sps=56e6, duration_sec=2e-3,
                          frequency_hz=7.3e6, pulse_width_sec=100e-6,
                          pri_sec=500e-6, start_index=1234, noise_std=3e-3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap.iq")
        out = os.path.join(tmp, "pdw.npz")
        write_training_iq(path, spec, sample_start_time=1723800000.0)
        common = ["--max-pulses", "64", "--max-pulse-samples", "1024",
                  "--device", DEVICE]
        rc = main(["pdw", path, "--channelized", "--out", out] + common)
        check(rc == 0, f"cli: exit code {rc}")
        p = dict(np.load(out))

        # the same samples as two contiguous files through pdw --stream
        hdr, samples = iqpacket.read_iq(path)
        samples = np.asarray(samples)
        half = len(samples) // 2
        parts = [os.path.join(tmp, f"part{i}.iq") for i in range(2)]
        for i, part in enumerate((samples[:half], samples[half:])):
            iqpacket.write_iq(parts[i], dataclasses.replace(
                hdr, num_samples=len(part),
                sample_start_time=hdr.sample_start_time
                + i * half / hdr.sample_rate_sps), part)
        out = os.path.join(tmp, "pdw_stream.npz")
        rc = main(["pdw", *parts, "--stream", "--channelized",
                   "--block-frames", "1024", "--checkpoint-dir",
                   os.path.join(tmp, "ck"), "--out", out] + common)
        check(rc == 0, f"cli --stream: exit code {rc}")
        ps = dict(np.load(out))

        out = os.path.join(tmp, "pdw_wide.npz")
        rc = main(["pdw", path, "--max-pulses", "64", "--max-pulse-samples",
                   "8192", "--device", DEVICE, "--out", out])
        check(rc == 0, f"cli wideband: exit code {rc}")
        pw = dict(np.load(out))

        # the capture tier: record (in-process emulator), predict on the
        # recorded dwells, track three dwells, gain-search
        rec = os.path.join(tmp, "rec")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = main(["record", "1000", "8", "2", "62", "0.01", "0.03", "0",
                       "--out-dir", rec, "--offset-mhz", "0.31", "--pw-us",
                       "100", "--pri-us", "2000", "--noise-db", "-55",
                       "--python-emulator"])
        recorded = said.getvalue().split()
        check(rc == 0 and len(recorded) == 3,
              f"cli record: exit {rc}, {len(recorded)} files")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = main(["predict", *recorded, "--max-pulse-samples", "4096",
                       "--device", DEVICE])
        predicted = said.getvalue()
        check(rc == 0 and "Next event:" in predicted,
              f"cli predict: exit {rc}: {predicted[-300:]}")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = main(["track", "1000", "8", "1", "60", "0.08", "0.24",
                       "--offset-mhz", "0.1", "--pw-us", "10", "--pri-us",
                       "5000", "--noise-db", "-55", "--amplitude", "0.9",
                       "--device", DEVICE])
        tracked = said.getvalue().splitlines()
        check(rc == 0 and len(tracked) == 3
              and all("pulses=" in t for t in tracked),
              f"cli track: exit {rc}: {tracked}")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = main(["gain-search", "1000", "8", "1", "64", "0.002", "0.02",
                       "--offset-mhz", "0.13", "--noise-db", "-300"])
        check(rc == 0 and "Max unsaturated gain: 59.0 dB" in said.getvalue(),
              f"cli gain-search: exit {rc}")
        views, skipped = cli_views(tmp, path, os.path.join(tmp, "pdw.npz"),
                                   recorded, common)
    starts = pulse_starts(spec)
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - spec.frequency_hz) < 0.5e6)
    check(int(sel.sum()) == len(starts),
          f"cli: {int(sel.sum())} pulses in the tone's bin, {len(starts)} sent")
    toa = p["toa"][sel] - 1723800000.0
    want = (starts + 1) / spec.sample_rate_sps
    check(float(np.abs(toa - want).max()) < 4e-6, "cli: TOA off the truth")
    check(float(np.abs(p["pw"][sel] - spec.pulse_width_sec).max()) < 12e-6,
          "cli: pulse width off the truth")
    pdws_agree(ps, p, "cli --stream vs cli")
    check(len(pw["toa"]) == len(starts),
          f"cli wideband: {len(pw['toa'])} pulses, {len(starts)} sent")
    check(float(np.abs(pw["toa"] - 1723800000.0 - want).max()) < 0.5e-6
          and float(np.abs(pw["pw"] - spec.pulse_width_sec).max()) < 1e-6
          and float(np.abs(pw["freq"] - spec.frequency_hz).max()) < 2e3,
          "cli wideband: TOA, width or frequency off the truth")
    emit("cli", pulses=int(len(p["toa"])), in_tone_bin=int(sel.sum()),
         sent=int(len(starts)), stream_pulses=int(len(ps["toa"])),
         wideband_pulses=int(len(pw["toa"])), recorded=len(recorded),
         predict=predicted.splitlines()[-1], track=tracked, views=views,
         skipped=skipped)
    return skipped


def cli_views(tmp: str, path: str, pdw_npz: str, recorded: list,
              common: list):
    """``convert`` to every container, ``pdw --channelized`` on each (the
    ``.iq`` run's PDWs bit for bit), ``spectrogram``, ``plot``, ``pdw
    --png`` and ``predict --png`` (with ``matplotlib``), ``txrx`` and
    ``provision --dry-run``.  A step whose library is missing is left out
    and listed."""
    from sdr_channelizer_tpu_torch.capture.txrx import matched_filter_delay
    from sdr_channelizer_tpu_torch.io import iqpacket

    skipped = []
    d = os.path.join(tmp, "views")
    containers = {path: True}   # path: whether it holds the raw payload
    for flags in (["--raw"], [], ["--mat", "--raw"], ["--mat"],
                  ["--mat", "--v73", "--raw"]):
        if "--v73" in flags and not have("h5py"):
            skipped.append({"step": "convert --mat --v73", "missing": "h5py"})
            continue
        name = "_".join(f.lstrip("-") for f in flags) or "npz"
        out = run_cli(["convert", path, "--out-dir", os.path.join(d, name)]
                      + flags)[-1]
        check(os.path.getsize(out) > 0, f"cli convert {flags}: empty file")
        containers[out] = "--raw" in flags
    # pdw on each container: a raw payload gives the .iq file's PDWs bit for
    # bit (the same packed main path), a float one within the float bars
    ref = dict(np.load(pdw_npz))
    for i, (c, raw) in enumerate(list(containers.items())[1:]):
        npz = os.path.join(d, f"pdw_{i}.npz")
        run_cli(["pdw", c, "--channelized", "--out", npz] + common)
        got = dict(np.load(npz))
        (pdws_identical if raw else pdws_agree)(got, ref, f"cli pdw {c}")
    views = {"containers": [os.path.relpath(c, tmp) for c in containers]}
    if have("matplotlib"):
        pngs = []
        for c in containers:
            pngs += run_cli(["spectrogram", c, "--out-dir",
                             os.path.join(d, "spec", str(len(pngs)))])
            pngs += run_cli(["plot", c, "--out-dir",
                             os.path.join(d, "plot", str(len(pngs)))])
        png = os.path.join(d, "pdw.png")
        pngs.append(run_cli(["pdw", path, "--channelized", "--out",
                             os.path.join(d, "pdw_png.npz"), "--png", png]
                            + common)[-1])
        png = os.path.join(d, "predict.png")
        run_cli(["predict", *recorded, "--max-pulse-samples", "4096",
                 "--device", DEVICE, "--png", png])
        pngs.append(png)
        for p in pngs:
            with open(p, "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"cli: {p} is "
                                                          f"not a PNG")
        views["pngs"] = len(pngs)
    else:
        skipped += [{"step": step, "missing": "matplotlib"} for step in
                    ("spectrogram", "plot", "pdw --png", "predict --png")]
    tx, rx = run_cli(["txrx", "1000", "8", "8", "0", "0.01", "0.004",
                      "10e-6", "1e-3", "--barker13", "--out-dir",
                      os.path.join(d, "txrx")])
    tx_iq, rx_iq = (iqpacket.to_complex(np.asarray(iqpacket.read_iq(f)[1]),
                                        12) for f in (tx, rx))
    delay = matched_filter_delay(tx_iq, rx_iq, max_lag=8000)
    check(delay == 100, f"cli txrx: matched-filter delay {delay}, not 100")
    lines = run_cli(["provision", "A5", "--dry-run"])
    check(lines == ["bladeRF-cli -l ~/workarea/hostedxA5_v0.15.3.rbf",
                    "bladeRF-cli -f ~/workarea/bladeRF_fw_v2.4.0.img",
                    "bladeRF-cli -e info -e version"],
          f"cli provision --dry-run: {lines}")
    views.update(txrx_delay=delay, provision_lines=len(lines))
    return views, skipped


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script has no CPU path",
              file=sys.stderr)
        return 2
    # outside a checkout this fails here, before any line is printed
    import sdr_channelizer_tpu_torch  # noqa: F401

    try:
        card = phase_env()
        phase_build()
        pipe = main_pipe()
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        small = (kernels_small() + [{"case": "K4 / B10 crafted runs",
                                     **kernels_small_pulse_stats()}]
                 + kernels_small_latch_nf()
                 + kernels_small_flip_flat_complex())
        caps = main_captures()
        xq = torch.as_tensor(pack(caps["dense"]), device=pipe.device)
        rows = kernels_main_shape(xq, pipe)
        kernels_flat_complex_main_shape(xq, caps["dense"], pipe, rows)
        del xq
        torch.cuda.empty_cache()
        dwells = kernels_long_window(rows)
        emit("kernels", small_shapes=small, main_shape="M=64 T=262144, dense "
             "capture", block_shape=f"M=64 T={BLOCK_FRAMES + HALO_FRAMES}, "
             "block 1 of the dense capture", long_window_shape="M=1 "
             "T=4480000, one predict dwell at the beam's peak",
             checked=[r["name"] for r in rows])
        launches = phase_main_path(pipe, caps)
        launches.update(phase_streaming(pipe, caps))
        launches.update(phase_routes(pipe, caps))
        launches.update(phase_wideband(rows, dwells))
        launches.update(phase_stats_batch(pipe, caps))
        launches.update(phase_predict())
        phase_track()
        if "--profile" in sys.argv[1:]:
            phase_profile(pipe, caps, rows)
            phase_profile_streaming(pipe, caps)
        phase_sharded(pipe, caps, rows)
        phase_cards(pipe, caps)
        skipped = phase_ingest_views(pipe, caps)
        skipped += phase_cli()
        phase_bench(pipe, caps)
        # the views' libraries are optional: what was left out, and why
        emit("skipped", steps=skipped,
             installed={lib: have(lib) for lib in ("matplotlib", "h5py",
                                                   "cv2", "scipy")},
             ffmpeg=shutil.which("ffmpeg") is not None)
    except SmokeFailure as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1

    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            print(json.dumps({"ok": False, "error":
                              f"{r['name']} was launched on no path"}),
                  flush=True)
            return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
