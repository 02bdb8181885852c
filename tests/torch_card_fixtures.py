"""What the card tests (``tests/test_torch_card_*.py``) share: the shapes
and captures of the port's main path, the tolerances, the comparison
helpers, and the fixtures that skip without a CUDA card.

This module imports no JAX, so that the card's machine can run the files
that import it:

    python -m pytest tests/test_torch_card_*.py tests/test_torch_staging_ring.py \\
        -q -p no:cacheprovider -o addopts="" --noconftest -m card

Nothing here touches the card at import: a fixture decides whether there
is one, and the captures and pipelines are built only then.
"""

import contextlib
import functools
import importlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
# the sparse capture's pulse trains, (f0, pw, pri), as bench.make_capture
# lays them (the first at sample 137, each next one 1000 samples later)
SPARSE_TRAINS = ((1.0e6, 100e-6, 1e-3), (-8.0e6, 50e-6, 0.7e-3))

# tolerances (the JAX package's own bars)
MAG_TOL = 1e-5          # rtol = atol; the DFT sums in another order
DPH_TOL_DEG = 0.05      # modulo 360; plus the angle MAG_TOL subtends at |y|
SAT_HOVER = 1e-5        # |Re| or |Im| this close to the level may flip
SNR_TOL_DB = 1e-3
FREQ_TOL_HZ = 50.0
SPEC_TOL = 1e-5         # of the mesh's largest power (float32 products)
EVENT_MAG_RTOL = 2e-5   # float32 prefix sums in another order
DENSE_COUNT_BAND = 0.02  # kernels' vs plain versions' pulse count


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def card():
    """The first CUDA card, with the kernel sources built; skips without
    one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the port's kernels")
    from sdr_channelizer_tpu_torch.ops.cuda import _build

    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    return torch.device(DEVICE, 0)


@pytest.fixture(scope="module")
def caps(card):
    """The sparse and dense captures of M_MAIN * FRAMES_MAIN samples."""
    return main_captures()


@pytest.fixture(scope="module")
def pipe(card):
    """The main path's pipeline, a fresh one a module."""
    return main_pipe()


@functools.cache
def main_captures() -> dict:
    n = M_MAIN * FRAMES_MAIN
    return {"sparse": bench.quantize(bench.make_capture(n, M_MAIN, True)),
            "dense": bench.quantize(bench.make_capture(n, M_MAIN, False))}


def main_pipe():
    """The main path's pipeline: M = 64, ``PdwConfig.channelized(512,
    1024)``, on the card."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    return ChannelizerPipeline.create(
        M_MAIN, device=DEVICE,
        pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024))


# ---------------------------------------------------------------- captures

def quantize(cap: np.ndarray, bit_width: int) -> np.ndarray:
    """complex64 in [-1, 1) -> interleaved integer (I, Q) pairs at any bit
    width (``bench.quantize`` is the one at 12)."""
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


# ----------------------------------------------------------- comparisons

def same(a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs(a, b) -> float:
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def outputs_identical(a, b, where: str) -> None:
    """Two steps' outputs (tensors, tuples, ``PdwBatch``es) bit for bit."""
    from sdr_channelizer_tpu_torch._staging import map_tensors

    got, want = [], []
    map_tensors(got.append, a)
    map_tensors(want.append, b)
    check(len(got) == len(want) > 0, f"{where}: {len(got)} outputs vs "
                                     f"{len(want)}")
    for i, (x, y) in enumerate(zip(got, want)):
        check(x.shape == y.shape and x.dtype == y.dtype and same(x, y),
              f"{where}: output {i} differs")


def step_runs(staged, misses_before: int) -> int:
    """How many times one call of ``staged`` ran its step on the card, its
    ``misses`` read ``misses_before`` before it: the replay, and the eager
    warm-up where the call captured."""
    return 1 + staged.misses - misses_before


def off_boundary(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary:
    the flip and the fused form take their 4-byte (8-byte pair) loads on
    it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


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
                 history=None, band=None) -> None:
    """B5 against its plain version: magnitude at MAG_TOL, the phase at
    DPH_TOL_DEG (modulo 360) where |y| > 0.01, the mask equal but for samples
    whose |Re| or |Im| lies within SAT_HOVER of the level.  ``band``: the
    ``(c0, n)`` band slice both were given."""
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


def compare_streams(xq, taps, bit_width, sat_level, got, where: str,
                    history=None, band=None) -> None:
    """K1, or its cm form when ``got`` has four streams, against its plain
    version: magnitude and phase difference at the stated tolerances; the
    saturation exactly (as a count), but for samples whose |Re| or |Im| lies
    within SAT_HOVER of the level, which may flip.  ``band``: the ``(c0,
    n)`` band slice K1 and its plain version were given."""
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


def slot_grids(packed, m: int, p_slots: int, t_len: int):
    """Edge index grids (toa, te) from the latch counts, as the main path
    builds them."""
    from sdr_channelizer_tpu_torch.ops.rank_find import find_ranks_cm

    r = packed.shape[0] // 2
    ranks = torch.arange(1, p_slots + 1, dtype=torch.float32,
                         device=packed.device).expand(2 * r, p_slots)
    idx = find_ranks_cm(packed, ranks, t_len)
    return idx[:m].contiguous(), idx[r:r + m].contiguous()


def stats_nan_high(mag, dph, sat, toa, te, rows, window: int, t_len: int):
    """The statistics as a sort gives them with NaNs above every number,
    the padding included: the plain version's gather with NaN, not +inf, in
    the unused places of a window.  It differs from the plain version only
    where NaNs reach the middle ranks of a run (ROADMAP C)."""
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


def pdws_identical(a: dict, b: dict, where: str) -> None:
    for key in a:
        check(np.array_equal(a[key], b[key], equal_nan=True),
              f"{where}: {key} is not bit-identical")


def recovers_generator(pdws: dict, n: int, m: int) -> None:
    """Every generated pulse of the sparse capture that the other train does
    not overwrite is found in its channel, its TOA within the channelizer's
    group delay (P frames)."""
    fs = m * 1e6
    spans = []
    for k, (f0, pw, pri) in enumerate(SPARSE_TRAINS):
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


# ------------------------------------------------------- launch counters

def _counters(names: dict) -> dict:
    """``{name: (wrapper module, its counter's attribute)}`` for ``names``,
    a dict of name -> "module.attribute" under ``ops.cuda``."""
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


# ----------------------------------------------------- command line, views

def have(lib: str) -> bool:
    """Whether ``lib`` is installed (the views' libraries are optional)."""
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


def run_module_cli(argv, timeout: float = 600):
    """``python -m sdr_channelizer_tpu_torch <argv>`` in a fresh process."""
    return subprocess.run([sys.executable, "-m", "sdr_channelizer_tpu_torch",
                           *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
