#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the port's
main path (packed int16 capture -> channelizer -> noise floor -> latch ->
pulse statistics -> PDWs) at its real size, M = 64 bands x 262144 frames,
and runs the CLI once.  One JSON line per phase; any failure exits
non-zero.  ``--profile`` adds a phase that prints the device time of a step
by kernel name.  There is no CPU path: without a CUDA device the script exits at
once with code 2 and prints no result.

The last line of the standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

M_MAIN = 64
FRAMES_MAIN = 262144
BIT_WIDTH = 12
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores

# tolerances (the JAX package's own bars)
MAG_TOL = 1e-5          # rtol = atol; the DFT sums in another order
DPH_TOL_DEG = 0.05      # modulo 360; plus the angle MAG_TOL subtends at |y|
SAT_HOVER = 1e-5        # |Re| or |Im| this close to the level may flip
SNR_TOL_DB = 1e-3
FREQ_TOL_HZ = 50.0
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


def compare_streams(xq, taps, bit_width, sat_level, got, where: str) -> dict:
    """K1 against its plain version: magnitude and phase difference at the
    stated tolerances; the saturation count exactly, but for samples whose
    |Re| or |Im| lies within SAT_HOVER of the level, which may flip."""
    import torch

    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    mag, dph, satcs = got
    pm, pd, ps = ck.channelize_streams_packed_cm2_plain(
        xq, taps, bit_width, sat_level)
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
    yr, yi = ck.channelize_planes_plain(xq, taps, bit_width)
    hover = (((yr.abs() - sat_level).abs() <= SAT_HOVER)
             | ((yi.abs() - sat_level).abs() <= SAT_HOVER)).T
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
        # a second tile length, so the tiling itself is exercised
        alt = k.channelize_streams_packed_cm2(xq, taps, bw, 0.9999,
                                              tile_frames=8)
        check(all(same(a, b) for a, b in zip(alt, got)),
              f"K1 {where}: result depends on the tile length")

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
        packed = k.latch_cumsums_cm(mag, lead, lead, m)
        check(packed[:m, -1].sum() > 0, f"K3 {where}: no pulse detected")

        # K4: the slots the latch found, plus crafted ones
        toa, te = slot_grids(packed, m, 64, frames)
        toa[:, -1] = frames - 3     # touches t_len, capped by it
        te[:, -1] = frames
        toa[:, -2] = 7              # one-sample pulse: empty phase range
        te[:, -2] = 7
        toa[:, -3] = 11             # longer than any window here
        te[:, -3] = frames - 1
        toa[:, -4] = frames         # dead
        for window in (128, 256, 1000):
            a = k.pulse_stats(mag, dph, toa, te, window, frames)
            b = k.pulse_stats_plain(mag, dph, toa, te, window, frames)
            check(same(a[0], b[0]) and same(a[1], b[1]),
                  f"K4 {where} window={window}: off by "
                  f"{max_abs(a[0], b[0]):.3g} / {max_abs(a[1], b[1]):.3g}")
        torch.cuda.synchronize()
        cases.append({"case": where, **res})
    return cases


def kernels_main_shape(xq, pipe):
    """Every kernel against its plain version, and timed, at the main
    path's shapes, on the dense capture."""
    import torch

    from sdr_channelizer_tpu_torch.ops import cuda as k

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

    def row(name, source, replaces, err, exact, ms, plain_ms, library_ms,
            n_bytes, n_flop, **extra):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_flop = n_flop / FP32_FLOP_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"sdr_channelizer_tpu_torch/ops/cuda/csrc/{source}",
            "replaces": f"sdr_channelizer_tpu/ops/pallas/{replaces}",
            "launches": None, "max_abs_err": err, "exact": exact,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations",
            "library_ms": library_ms, **extra})

    # K1: capture read once, three streams written once; FIR + four products
    row("channelize_streams_packed_cm2", "channelizer.cu",
        "channelizer_kernel.py:718", res1["mag_err"], False,
        time_ms(lambda: k.channelize_streams_packed_cm2(
            xq, taps, BIT_WIDTH, cfg.saturation_level)),
        time_ms(lambda: k.channelize_streams_packed_cm2_plain(
            xq, taps, BIT_WIDTH, cfg.saturation_level), reps=3, warmup=1),
        None,
        n_bytes=xq.numel() * xq.element_size() + 3 * 4 * m * t_len
        + 4 * (p * m + 2 * m * m),
        n_flop=t_len * (4 * p * m + 8 * m * m), **res1)

    # K2
    a, b = k.noise_floor_cm(mag, t_len), k.noise_floor_cm_plain(mag, t_len)
    check(same(a, b), f"K2 main shape: off by {max_abs(a, b):.3g}")
    nf = a
    row("noise_floor_cm", "noise_floor.cu", "nf_kernel.py:112",
        max_abs(a, b), True,
        time_ms(lambda: k.noise_floor_cm(mag, t_len)),
        time_ms(lambda: k.noise_floor_cm_plain(mag, t_len), reps=3, warmup=1),
        time_ms(lambda: torch.sort(mag[:, :t_len], dim=1), reps=3, warmup=1),
        n_bytes=4 * m * t_len + 4 * m, n_flop=0)

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
        None, n_bytes=(4 + 8) * m * t_len + 12 * m, n_flop=0)

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
    row("pulse_stats", "pulse_stats.cu", "pulse_stats_kernel.py:771",
        err, True,
        time_ms(lambda: [k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
                         for t_s, e_s, w in tiers]),
        time_ms(lambda: [k.pulse_stats_plain(mag, dph, t_s, e_s, w, t_len)
                         for t_s, e_s, w in tiers], reps=3, warmup=1),
        None, n_bytes=live_bytes, n_flop=0,
        slots={"tiny": int(tiny.sum()), "short": int(short.sum()),
               "long": int(long_.sum())})
    return rows


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


def phase_profile(pipe, caps):
    """Only with ``--profile``: device time by kernel name over a few steps
    of the main path, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps = 5
    for name, samples in caps.items():
        xq = torch.as_tensor(pack(samples), device=pipe.device)
        pipe.forward_packed(xq, BIT_WIDTH)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                pipe.forward_packed(xq, BIT_WIDTH)
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
        busy = sum(r["ms_per_step"] for r in rows)
        emit("profile", capture=name, steps=steps,
             device_busy_ms_per_step=busy,
             kernels=rows[:14],
             rest_ms_per_step=sum(r["ms_per_step"] for r in rows[14:]))
        del xq


def phase_cli():
    """A synthetic ``.iq`` file through ``pdw --channelized`` on the card."""
    from sdr_channelizer_tpu_torch.cli.main import main
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec, pulse_starts, write_training_iq)

    spec = PulseTrainSpec(sample_rate_sps=56e6, duration_sec=2e-3,
                          frequency_hz=7.3e6, pulse_width_sec=100e-6,
                          pri_sec=500e-6, start_index=1234, noise_std=3e-3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap.iq")
        out = os.path.join(tmp, "pdw.npz")
        write_training_iq(path, spec, sample_start_time=1723800000.0)
        rc = main(["pdw", path, "--channelized", "--max-pulses", "64",
                   "--max-pulse-samples", "1024", "--device", DEVICE,
                   "--out", out])
        check(rc == 0, f"cli: exit code {rc}")
        p = dict(np.load(out))
    starts = pulse_starts(spec)
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - spec.frequency_hz) < 0.5e6)
    check(int(sel.sum()) == len(starts),
          f"cli: {int(sel.sum())} pulses in the tone's bin, {len(starts)} sent")
    toa = p["toa"][sel] - 1723800000.0
    want = (starts + 1) / spec.sample_rate_sps
    check(float(np.abs(toa - want).max()) < 4e-6, "cli: TOA off the truth")
    check(float(np.abs(p["pw"][sel] - spec.pulse_width_sec).max()) < 12e-6,
          "cli: pulse width off the truth")
    emit("cli", pulses=int(len(p["toa"])), in_tone_bin=int(sel.sum()),
         sent=int(len(starts)))


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

    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    try:
        card = phase_env()
        phase_build()
        pipe = ChannelizerPipeline.create(
            M_MAIN, device=DEVICE,
            pdw_cfg=PdwConfig.channelized(max_pulses=512,
                                          max_pulse_samples=1024))
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        small = kernels_small()
        n = M_MAIN * FRAMES_MAIN
        caps = {"sparse": quantize(make_capture(n, M_MAIN, sparse=True)),
                "dense": quantize(make_capture(n, M_MAIN, sparse=False))}
        xq = torch.as_tensor(pack(caps["dense"]), device=pipe.device)
        rows = kernels_main_shape(xq, pipe)
        del xq
        torch.cuda.empty_cache()
        emit("kernels", small_shapes=small, main_shape="M=64 T=262144, dense "
             "capture", checked=[r["name"] for r in rows])
        launches = phase_main_path(pipe, caps)
        if "--profile" in sys.argv[1:]:
            phase_profile(pipe, caps)
        phase_cli()
    except SmokeFailure as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
