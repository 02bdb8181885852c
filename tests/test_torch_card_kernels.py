"""Every hand-written CUDA kernel of the port against its plain PyTorch
version, on the card: at small and awkward shapes (tile and segment
boundaries, both load variants of the flip, crafted runs for the
statistics and crafted samples for the one-channel streams), then at the
main path's shape (M = 64 x 262144 frames of the dense capture), at the
streamed block's (M = 64 x 65536 + 1024 frames, entered with block 0's
history) and at one ``predict`` dwell (one channel x 4,480,000 samples,
window 65,536).  Each kernel's main case also sees its wrapper's launch
counter move, so that the plain version never stands in for it.

``KERNEL_SITES`` names, for each ``pl.pallas_call`` site of the JAX
package, the case here that holds its CUDA kernel.  Marked ``card``:
skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_kernels.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import numpy as np
import pytest
import torch

from torch_card_fixtures import (
    BIT_WIDTH, BLOCK_FRAMES, DEVICE, DWELL_SEC, EVENT_FS, FRAMES_MAIN,
    HALO_FRAMES, M_MAIN, MAG_TOL, PREDICT_WINDOW, SCAN, check, compare_flat,
    compare_streams, max_abs, off_boundary, pack, read_counts, same,
    slot_grids, small_capture, stats_nan_high)
from torch_card_fixtures import caps, card, pipe  # noqa: F401  (fixtures)

pytestmark = pytest.mark.card

# each pl.pallas_call site of sdr_channelizer_tpu/ops/pallas -> the case of
# this file that holds its CUDA kernel at the shape the port runs it
KERNEL_SITES = {
    "channelizer_kernel.py:224": "test_b9_main_shape",
    "channelizer_kernel.py:602": "test_b5_main_shape",
    "channelizer_kernel.py:655": "test_b6_block_shape",
    "channelizer_kernel.py:718": "test_k1_main_shape",
    "latch_kernel.py:211": "test_k3_main_shape",
    "latch_kernel.py:283": "test_b7_block_shape",
    "nf_kernel.py:112": "test_k2_main_shape",
    "pulse_stats_kernel.py:771": "test_k4_main_shape",
    "transpose_kernel.py:136": "test_b8_main_shape",
}


def launched(counter: str, fn):
    """``fn()``, failing unless the wrapper's launch counter ``counter``
    ("module.attribute" under ``ops.cuda``) moved: the CUDA kernel ran."""
    before = read_counts({"c": counter})["c"]
    out = fn()
    torch.cuda.synchronize()
    check(read_counts({"c": counter})["c"] > before,
          f"{counter}: the kernel was not launched")
    return out


# ------------------------------------------------------------ small shapes

SMALL = [(8, 1003, 12), (20, 777, 12), (56, 650, 8), (64, 2049, 12),
         (64, 901, 8), (12, 4100, 16), (560, 650, 12)]


@pytest.mark.parametrize("m,frames,bw", SMALL,
                         ids=[f"M{m}-T{f}-bw{b}" for m, f, b in SMALL])
def test_small_shapes(card, m, frames, bw):
    """K1, B6 (with histories), K2, K3, B7 and K4 / B10 (grid, flat list,
    with the mask) against their plain versions at small and awkward
    shapes."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    where = f"M={m} T={frames} bw={bw}"
    taps = Channelizer.create(m).taps_rev
    xq = torch.as_tensor(pack(small_capture(m, frames, bw, seed=m + bw)),
                         device=dev)
    got = k.channelize_streams_packed_cm2(xq, taps, bw, 0.9999)
    torch.cuda.synchronize()
    compare_streams(xq, taps, bw, 0.9999, got, "K1 " + where)
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


def test_pulse_stats_crafted_runs(card):
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

    nan_middle_slots = 0
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
        nan_middle_slots += int(sum((~a).sum() for a in agree))
    check(nan_middle_slots > 0,
          "K4 crafted runs: no run has NaNs in its middle ranks")


def test_b10_live_tiles_list(card):
    """B10's list of live tiles, built on the card, against its plain
    version."""
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    dev = torch.device(DEVICE)
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


def _nf_fits(mag, t_len: int) -> int:
    """Rows of ``mag`` whose keys under the median's top 12 bits fit K2's
    candidate buffer: the rows whose last digits are not taken from the row
    itself."""
    from sdr_channelizer_tpu_torch.ops.cuda import nf_kernel
    from sdr_channelizer_tpu_torch.ops.medians import sortable_u32

    lo = torch.sort(mag[:, :t_len], dim=1).values[:, (t_len - 1) // 2]
    top = sortable_u32(lo) >> 20
    n_in = (sortable_u32(mag[:, :t_len]) >> 20 == top[:, None]).sum(dim=1)
    cap = nf_kernel._library().sdr_noise_floor_cap(t_len)
    return int((n_in <= cap).sum())


SEG = 4096
K3_SEGMENTS = [(16, 13, SEG - 1), (16, 13, SEG), (16, 13, SEG + 1),
               (16, 13, 3 * SEG + 1), (1, 1, 3 * SEG + 1), (64, 61, SEG + 3),
               (3, 2, 5)]


@pytest.mark.parametrize("r,m_real,t_len", K3_SEGMENTS,
                         ids=[f"R{r}-m{m}-T{t}" for r, m, t in K3_SEGMENTS])
def test_k3_segment_scan(card, r, m_real, t_len):
    """K3's segment scan with T one frame short of, on and past a segment
    (4096 frames) and three segments and one, one row, pad rows (m_real <
    R), rows whose start is not 16 bytes aligned; pulses over segment
    boundaries, thresholds met exactly, a row that only holds."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(6)
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


def test_k3_unaligned_rows(card):
    """K3 on rows that start 4 bytes past a 16-byte boundary."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(6)
    base = torch.rand((8 * 5003 + 1,), device=dev, generator=gen)
    mag = base[1:].view(8, 5003)
    lead = torch.full((8,), 0.9, device=dev)
    trail = torch.full((8,), 0.2, device=dev)
    check(same(k.latch_cumsums_cm(mag, lead, trail),
               k.latch_cumsums_cm_plain(mag, lead, trail)),
          "K3 unaligned rows: differs from plain")


def test_k2_select(card):
    """K2's select with odd and even lengths, candidates that overflow the
    buffer (quantized, constant-heavy rows), a sample that misses the
    median, hi in the 12-bit bin after lo's, NaNs, subnormals, rows far
    apart and a 1-D row."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(6)

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


FLIP_SHAPES = [(1, 1), (2, 1), (1, 3), (2, 3), (2500, 1), (4099, 1),
               (255, 1), (257, 1), (1003, 3), (777, 56), (2049, 64),
               (3001, 33), (2049, 2), (127, 6), (129, 4), (130, 65),
               (1, 64), (4097, 560)]


@pytest.mark.parametrize("t_len,m", FLIP_SHAPES,
                         ids=[f"T{t}-M{m}" for t, m in FLIP_SHAPES])
def test_b8_shapes(card, t_len, m):
    """B8 exact at any M from 1 and any T (on both sides of its 128-frame
    tile and of the one-channel pass's 256-sample warp span), t_len 1 and
    2, both mask dtypes, an infinite magnitude and a NaN phase carried
    through.  The kernel takes 16-byte loads on fresh tensors where M % 4
    == 0 or M = 1, 4-byte ones where M % 4 != 0."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
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


FLIP_VIEWS = [(1001, 1), (1001, 3), (1001, 4), (513, 64)]


@pytest.mark.parametrize("t_len,m", FLIP_VIEWS,
                         ids=[f"T{t}-M{m}" for t, m in FLIP_VIEWS])
def test_b8_views(card, t_len, m):
    """B8 on views into a longer buffer, at an element offset of 1 (off a
    16-byte boundary: the 4-byte loads) and of 4 (on one: the 16-byte
    loads where M % 4 == 0 or M = 1); the kernel launches (the counter
    moves) and gives the plain bits, never the plain version in its
    place."""
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel as tk

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
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


def test_wideband_streams_crafted(card):
    """The one-channel streams from the capture, bit for bit the plain
    chain (prep_streams, then the flip's plain version) on crafted samples:
    exactly at the saturation level and just under it, phase steps of
    exactly +-180 and +-360, +-0 in both parts, +-inf and NaN; T of 1, 2,
    on both sides of a warp span; as a fresh capture (16-byte loads) and
    as a view one sample in (8 bytes off: a pair a load)."""
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel as tk

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
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


@pytest.mark.parametrize("m", [1, 3, 64])
def test_b7_absent_channels(card, m):
    """B7 where a block has absent channels."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
    mag = torch.rand((5003, m), device=dev, generator=gen)
    hi = torch.full((m,), 0.9, device=dev)
    lo = torch.full((m,), 0.3, device=dev)
    for ent in (None, (torch.arange(m, device=dev) % 2).float()):
        c = k.latch_cumsums(mag, hi, lo, ent)
        d = k.latch_cumsums_plain(mag, hi, lo, ent)
        check(same(c, d), f"B7 M={m}: off by {max_abs(c, d):.3g}")


@pytest.mark.parametrize("m,t_len", [(1, 70001), (9, 9001), (64, 6001)],
                         ids=["M1-T70001", "M9-T9001", "M64-T6001"])
def test_b7_segment_scan(card, m, t_len):
    """B7's scan across segments (4096 frames at M = 1, 512 else): a pulse
    over many segments, holds over whole segments between a set and a
    reset, thresholds met exactly on segment boundaries, a latch entered
    active that sees no transfer at all."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
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


def test_b7_one_channel_2_24(card):
    """B7 at M = 1 and T = 2^24 - 1: 17 pulses counted, the plain bits."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
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


@pytest.mark.parametrize("m", [64, 65])
def test_body_tile_boundaries(card, m):
    """The channelizer body at T on tile boundaries (7440 is a multiple of
    every tile length the wrappers choose here: 15, 31 with the look-ahead
    frame, 16, 32 without): K1, B6, B5 against their plain versions, and
    B5's |y| = B6's = K1's, bit for bit."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
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


FLAT_SMALL = [(3, 777, 12), (8, 1003, 12), (56, 650, 8), (64, 2049, 12)]


@pytest.mark.parametrize("m,frames,bw", FLAT_SMALL,
                         ids=[f"M{m}-T{f}-bw{b}" for m, f, b in FLAT_SMALL])
def test_flat_and_complex_small(card, m, frames, bw):
    """B5 and B9, packed and planes ingests, with a history."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE)
    where = f"M={m} T={frames} bw={bw}"
    taps = Channelizer.create(m).taps_rev
    p_taps = taps.shape[0]
    samples = small_capture(m, frames, bw, seed=m + bw)
    xq = torch.as_tensor(pack(samples), device=dev)
    flat = k.channelize_streams_packed(xq, taps, bw, 0.9999)
    compare_flat(xq, taps, bw, 0.9999, flat, "B5 " + where)
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


# -------------------------------------------------------- the main shape

@pytest.fixture(scope="module")
def dense_xq(caps, pipe):
    """The dense capture, packed, on the card."""
    return torch.as_tensor(pack(caps["dense"]), device=pipe.device)


@pytest.fixture(scope="module")
def main_streams(dense_xq, pipe):
    """K1's streams of the dense capture at M = 64 x 262144 frames."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    return launched("channelizer_kernel.launches",
                    lambda: k.channelize_streams_packed_cm2(
                        dense_xq, pipe.channelizer.taps_rev, BIT_WIDTH,
                        pipe.pdw_cfg.saturation_level))


@pytest.fixture(scope="module")
def main_tiers(main_streams, pipe):
    """The two tier calls of a step's statistics, on the slots the dense
    capture gives: ``(t_s, e_s, window)`` each."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    m, t_len = M_MAIN, FRAMES_MAIN
    cfg = pipe.pdw_cfg
    mag = main_streams[0]
    nf = k.noise_floor_cm(mag, t_len)
    lead = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
    packed = k.latch_cumsums_cm(mag, lead, lead, m)
    toa, te = slot_grids(packed, m, cfg.max_pulses, t_len)
    plen = te - toa + 1
    closed = (toa < t_len) & (te < t_len)
    tiny = closed & (plen <= 2)
    short = closed & ~tiny & (plen <= 128)
    long_ = (toa < t_len) & ~tiny & ~short
    sentinel = torch.full((), t_len, dtype=torch.int32, device=toa.device)
    return [(torch.where(s, toa, sentinel), torch.where(s, te, sentinel), w)
            for s, w in ((short, 128), (long_, cfg.max_pulse_samples))]


def test_k1_main_shape(dense_xq, main_streams, pipe):
    """K1 at the main shape against its plain version (the launch counted
    by the fixture that made the streams)."""
    compare_streams(dense_xq, pipe.channelizer.taps_rev, BIT_WIDTH,
                    pipe.pdw_cfg.saturation_level, main_streams,
                    "K1 main shape")


def test_k2_main_shape(main_streams):
    from sdr_channelizer_tpu_torch.ops import cuda as k

    mag = main_streams[0]
    a = launched("nf_kernel.launches",
                 lambda: k.noise_floor_cm(mag, FRAMES_MAIN))
    b = k.noise_floor_cm_plain(mag, FRAMES_MAIN)
    check(same(a, b), f"K2 main shape: off by {max_abs(a, b):.3g}")


def test_k3_main_shape(main_streams, pipe):
    from sdr_channelizer_tpu_torch.ops import cuda as k

    mag = main_streams[0]
    nf = k.noise_floor_cm(mag, FRAMES_MAIN)
    lead = nf * 10.0 ** (pipe.pdw_cfg.snr_threshold_db / 10.0)
    a = launched("latch_kernel.launches",
                 lambda: k.latch_cumsums_cm(mag, lead, lead, M_MAIN))
    b = k.latch_cumsums_cm_plain(mag, lead, lead, M_MAIN)
    check(same(a, b), f"K3 main shape: off by {max_abs(a, b):.3g}")


def test_k4_main_shape(main_streams, main_tiers):
    """K4: the two tier calls of a step, on the slots this capture
    gives."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    mag, dph, _ = main_streams
    for t_s, e_s, w in main_tiers:
        a = launched("pulse_stats_kernel.launches", lambda: k.pulse_stats(
            mag, dph, t_s, e_s, w, FRAMES_MAIN))
        b = k.pulse_stats_plain(mag, dph, t_s, e_s, w, FRAMES_MAIN)
        check(same(a[0], b[0]) and same(a[1], b[1]),
              f"K4 main shape window={w}: off by {max_abs(a[0], b[0]):.3g}"
              f" / {max_abs(a[1], b[1]):.3g}")


def test_b10_main_shape(main_streams, main_tiers):
    """B10: the same two tier calls with batch_tiles = 8, as the cm2 tail
    makes them with _STATS_BATCH = 8: 8 tiles a batch at window 128, 5 at
    window 1024; bit for bit K4's and the plain version's."""
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    mag, dph, _ = main_streams
    t_len = FRAMES_MAIN
    nts = [psk.batched_tiles(8, w, t_s.numel()) for t_s, _, w in main_tiers]
    check(nts == [8, 5], f"B10 main shape: {nts} tiles a batch, not [8, 5]")
    for t_s, e_s, w in main_tiers:
        a = launched("pulse_stats_kernel.launches_batched",
                     lambda: k.pulse_stats(mag, dph, t_s, e_s, w, t_len,
                                           batch_tiles=8))
        b = k.pulse_stats_plain(mag, dph, t_s, e_s, w, t_len, batch_tiles=8)
        c = k.pulse_stats(mag, dph, t_s, e_s, w, t_len)
        check(same(a[0], b[0]) and same(a[1], b[1]) and same(a[0], c[0])
              and same(a[1], c[1]), f"B10 main shape window={w}: differs "
                                    f"from plain or from K4")


@pytest.fixture(scope="module")
def main_flat(dense_xq, pipe):
    """B5's streams of the dense capture at the main shape."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    return launched("channelizer_kernel.launches_flat",
                    lambda: k.channelize_streams_packed(
                        dense_xq, pipe.channelizer.taps_rev, BIT_WIDTH,
                        pipe.pdw_cfg.saturation_level))


def test_b5_main_shape(dense_xq, main_flat, pipe):
    """B5 against its plain version at M = 64 x 262144 frames on the dense
    capture, and its magnitude B6's time-major one bit for bit."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    taps = pipe.channelizer.taps_rev
    sat_level = pipe.pdw_cfg.saturation_level
    compare_flat(dense_xq, taps, BIT_WIDTH, sat_level, main_flat,
                 "B5 main shape")
    cm = k.channelize_streams_packed_cm(dense_xq, taps, BIT_WIDTH, sat_level)
    check(same(main_flat[0], cm[0]), "B5 main shape: mag is not B6's "
                                     "time-major mag bit for bit")


def test_b7_flat_route_shape(main_flat, pipe):
    """B7 on the magnitude B5 gives it, with the flat route's
    thresholds."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.medians import median

    mag = main_flat[0]
    cfg = pipe.pdw_cfg
    lead, trail = pdwmod._thresholds(median(mag, dim=0), cfg.snr_threshold_db,
                                     cfg.trailing_threshold_db)
    a = k.latch_cumsums(mag, lead, trail)
    b = k.latch_cumsums_plain(mag, lead, trail)
    check(same(a, b), f"B7 flat-route shape: off by {max_abs(a, b):.3g}")
    check(float(a[:M_MAIN, -1].sum()) > 0,
          "B7 flat-route shape: no edge counted")


def test_b8_main_shape(main_flat):
    """B8 with the bool mask, then with B5's float mask as route "flat"
    hands it over; each on the fresh streams (16-byte loads) and on copies
    one element off a 16-byte boundary (4-byte loads), bit for bit."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    mag, ph, sat_f = main_flat
    for name, mask in (("bool", sat_f > 0.5), ("float", sat_f)):
        b = k.cm_streams_plain(mag, ph, mask)
        for loads, streams in (("16_byte", (mag, ph, mask)),
                               ("4_byte_off_boundary",
                                tuple(off_boundary(t)
                                      for t in (mag, ph, mask)))):
            a = launched("transpose_kernel.launches",
                         lambda: k.cm_streams(*streams))
            check(all(same(x, y) for x, y in zip(a, b)),
                  f"B8 main shape, {name} mask, {loads} loads: differs from "
                  f"plain")


def test_b9_main_shape(caps, pipe):
    """B9 against its plain version at the main shape on the dense
    capture's complex samples."""
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops import cuda as k

    taps = pipe.channelizer.taps_rev
    x = torch.as_tensor(iqpacket.to_complex(caps["dense"], BIT_WIDTH),
                        device=pipe.device)
    y = launched("channelizer_kernel.launches_complex",
                 lambda: k.channelize_complex(x, taps))
    yp = k.channelize_complex_plain(x, taps)
    err = float((y - yp).abs().max())
    check(torch.allclose(torch.view_as_real(y), torch.view_as_real(yp),
                         rtol=MAG_TOL, atol=MAG_TOL),
          f"B9 main shape: off by {err:.3g}")


# ------------------------------------------------------ the block shape

@pytest.fixture(scope="module")
def block(dense_xq, pipe):
    """Block 1 of the dense capture with its halo, M = 64 x (65536 + 1024)
    frames, and the packed history of block 0's tail: ``(blk, hist,
    t_len)``."""
    m, t_len = M_MAIN, BLOCK_FRAMES + HALO_FRAMES
    p = pipe.channelizer.taps_rev.shape[0]
    f0 = BLOCK_FRAMES
    return (dense_xq[f0 * m: (f0 + t_len) * m],
            dense_xq[(f0 - (p - 1)) * m: f0 * m], t_len)


@pytest.fixture(scope="module")
def block_cm(block, pipe):
    """B6's four streams of the block."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    blk, hist, _ = block
    return launched("channelizer_kernel.launches_cm",
                    lambda: k.channelize_streams_packed_cm(
                        blk, pipe.channelizer.taps_rev, BIT_WIDTH,
                        pipe.pdw_cfg.saturation_level, history=hist))


@pytest.fixture(scope="module")
def block_slots(block, block_cm, pipe):
    """The block's floor and lead threshold, its slot grids and tiers:
    ``(lead, toa, te, tiny, short, long_, sentinel, chan)``."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    _, _, t_len = block
    mag_tm, mag, _, _ = block_cm
    cfg = pipe.pdw_cfg
    m = M_MAIN
    nf = k.noise_floor_cm(mag, t_len)
    lead = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
    packed = k.latch_cumsums(mag_tm, lead, lead)
    toa, te = slot_grids(packed, m, cfg.max_pulses, t_len)
    plen = te - toa + 1
    closed = (toa < t_len) & (te < t_len)
    tiny = closed & (plen <= 2)
    short = closed & ~tiny & (plen <= 128)
    long_ = (toa < t_len) & ~tiny & ~short
    sentinel = torch.full((), t_len, dtype=torch.int32, device=toa.device)
    chan = torch.arange(m, dtype=torch.int32,
                        device=toa.device).repeat_interleave(toa.shape[1])
    return lead, toa, te, tiny, short, long_, sentinel, chan


def test_b6_block_shape(block, block_cm, pipe):
    """B6 at the streamed block's shape against its plain version, and
    mag_cm / dph_cm the same bits as K1's."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    blk, hist, _ = block
    taps = pipe.channelizer.taps_rev
    sat_level = pipe.pdw_cfg.saturation_level
    compare_streams(blk, taps, BIT_WIDTH, sat_level, block_cm,
                    "B6 block shape", history=hist)
    k1 = k.channelize_streams_packed_cm2(blk, taps, BIT_WIDTH, sat_level,
                                         history=hist)
    check(same(block_cm[1], k1[0]) and same(block_cm[2], k1[1])
          and same(torch.cumsum(block_cm[3], dim=1), k1[2]),
          "B6 block shape: streams are not K1's bits")


def test_b7_block_shape(block_cm, block_slots):
    """B7 at the block shape, entered with a mixed state; K3 entered active
    on the same block, and B7 its bits on the flip."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    mag_tm, mag, _, _ = block_cm
    lead = block_slots[0]
    m = M_MAIN
    entry = (torch.arange(m, device=mag.device) % 2).to(torch.float32)
    a = launched("latch_kernel.launches_tm",
                 lambda: k.latch_cumsums(mag_tm, lead, lead, entry))
    b = k.latch_cumsums_plain(mag_tm, lead, lead, entry)
    check(same(a, b), f"B7 block shape: off by {max_abs(a, b):.3g}")
    c = k.latch_cumsums_cm(mag, lead, lead, m, entry)
    check(same(c, k.latch_cumsums_cm_plain(mag, lead, lead, m, entry)),
          "K3 block shape, entered active: differs from plain")
    check(same(a, c), "B7 block shape: differs from K3 on the flip")


def test_k4_sat_block_shape(block, block_cm, block_slots, pipe):
    """K4 with the saturation mask on the slot grid at the full window."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    _, _, t_len = block
    _, mag, dph, sat = block_cm
    _, toa, te, tiny, _, _, sentinel, _ = block_slots
    w = pipe.pdw_cfg.max_pulse_samples
    grid = (torch.where(~tiny, toa, sentinel), torch.where(~tiny, te, sentinel))
    a = launched("pulse_stats_kernel.launches",
                 lambda: k.pulse_stats(mag, dph, *grid, w, t_len, sat))
    b = k.pulse_stats_plain(mag, dph, *grid, w, t_len, sat)
    check(all(same(x, y) for x, y in zip(a, b)),
          "K4 sat_cm block shape: differs from plain")


def _block_tiers(block_slots, w):
    _, toa, te, _, short, long_, sentinel, _ = block_slots
    return [(torch.where(s_, toa, sentinel).reshape(-1),
             torch.where(s_, te, sentinel).reshape(-1), win)
            for s_, win in ((short, 128), (long_, w))]


def test_k4_dense_block_shape(block, block_cm, block_slots, pipe):
    """K4 on the two tiers as flat lists with the mask, as the streamed
    block's tail calls them."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    _, _, t_len = block
    _, mag, dph, sat = block_cm
    chan = block_slots[-1]
    for t_s, e_s, win in _block_tiers(block_slots,
                                      pipe.pdw_cfg.max_pulse_samples):
        a = launched("pulse_stats_kernel.launches_dense",
                     lambda: k.pulse_stats_dense(mag, dph, sat, t_s, e_s,
                                                 chan, win, t_len))
        b = k.pulse_stats_dense_plain(mag, dph, sat, t_s, e_s, chan, win,
                                      t_len)
        check(all(same(x, y) for x, y in zip(a, b)),
              f"K4 dense block shape window={win}: differs from plain")


def test_b10_dense_block_shape(block, block_cm, block_slots, pipe):
    """B10 on the flat lists with the mask, as the streamed block's tail
    calls it with _STATS_BATCH = 8: bit for bit K4's and the plain's."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    _, _, t_len = block
    _, mag, dph, sat = block_cm
    chan = block_slots[-1]
    for t_s, e_s, win in _block_tiers(block_slots,
                                      pipe.pdw_cfg.max_pulse_samples):
        a = launched("pulse_stats_kernel.launches_dense_batched",
                     lambda: k.pulse_stats_dense(mag, dph, sat, t_s, e_s,
                                                 chan, win, t_len,
                                                 batch_tiles=8))
        b = k.pulse_stats_dense_plain(mag, dph, sat, t_s, e_s, chan, win,
                                      t_len, batch_tiles=8)
        c = k.pulse_stats_dense(mag, dph, sat, t_s, e_s, chan, win, t_len)
        check(all(same(x, y) and same(x, z) for x, y, z in zip(a, b, c)),
              f"B10 dense block shape window={win}: differs from plain or "
              f"from K4")


# -------------------------------------------------- one predict dwell

@pytest.fixture(scope="module")
def dwell(card):
    """One dwell of the scanning beam at its peak (one channel x 4,480,000
    samples, synthesised on the card), its streams and ``predict``'s
    config: ``(xr, xi, mag, ph, sat, cfg, n)``."""
    from sdr_channelizer_tpu_torch.capture import DeviceDwellEmitter
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod

    n = int(round(DWELL_SEC * EVENT_FS))
    (xr, xi), _ = DeviceDwellEmitter(sample_rate_sps=EVENT_FS, **SCAN,
                                     device=DEVICE).receive(n, start_time=0.06)
    cfg = PdwConfig.event(max_pulse_samples=PREDICT_WINDOW)
    mag, ph, sat = pdwmod._prep_streams_planes(xr, xi, cfg.saturation_level)
    return xr, xi, mag, ph, sat, cfg, n


def test_k2_predict_shape(dwell):
    """K2 at the dwell's shape: the floor ``predict`` takes."""
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.medians import median

    _, _, mag, _, _, _, n = dwell
    row1 = mag[None]
    nf = k.noise_floor_cm(row1, n)
    nf_plain = k.noise_floor_cm_plain(row1, n)
    check(same(nf, nf_plain) and same(nf.reshape(()), median(mag)),
          f"K2 predict shape: off by {max_abs(nf, nf_plain):.3g}")


def test_wideband_streams_predict_shape(dwell):
    """The fused one-channel streams on the dwell as ``predict`` reads it:
    a complex capture."""
    from sdr_channelizer_tpu_torch.ops import cuda as k

    xr, xi, _, _, _, cfg, _ = dwell
    xc = torch.complex(xr, xi)
    level = cfg.saturation_level
    got = launched("transpose_kernel.launches_wideband",
                   lambda: k.wideband_streams(xc, level))
    check(all(same(a, b) for a, b in
              zip(got, k.wideband_streams_plain(xc, level))),
          "wideband_streams predict shape: differs from plain")


def test_k4_long_window(dwell):
    """B7 at the dwell's shape, then K4 at ``predict``'s window, 65,536:
    the dwell's pulses, which keep the shared-memory path, plus slots of
    60,000 and 70,000 samples, longer than a warp's stretch of shared
    memory, which take the selection from device memory."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k
    from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

    _, _, mag, ph, sat, cfg, n = dwell
    w = PREDICT_WINDOW
    nf = k.noise_floor_cm(mag[None], n)
    lead, trail = (t.reshape(1) for t in pdwmod._thresholds(
        nf[0], cfg.snr_threshold_db, cfg.trailing_threshold_db))
    packed = k.latch_cumsums(mag[:, None], lead, trail)
    check(same(packed, k.latch_cumsums_plain(mag[:, None], lead, trail)),
          "B7 predict shape: differs from plain")
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

    before = psk.launches_long_window
    a = k.pulse_stats_dense(mag_cm, dph_cm, sat_cm, toa_f, te_f, chan, w, n)
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
