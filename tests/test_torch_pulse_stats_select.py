"""The selection of kernels K4 and B10 (``csrc/pulse_stats.cu``), modelled
in NumPy pass for pass and held against the plain versions on the CPU.

The model follows the CUDA source: the chunk kernel's triage (dead slots
written 0, short runs sorted into classes of at most 8, 16, 32, 64 and 128
samples taken 4, 2, 1, 1, 1 a warp, longer runs to the select kernel's
list), the bitonic network a warp runs in registers (segments of W lanes),
and the select block's three digits (12, 10, 10 key bits) with the upper
middle following the lower one until its bin parts, a run longer than the
block's stretch read twice with its lower middle's 12-bit bin compacted
into shared memory or, where it does not fit, into the block's scratch.
The constants are read from the source, so the model cannot drift from it.

The kernels themselves run only on the card, where ``chip_smoke.py`` holds
them to the plain versions on the same kind of runs.
"""

import os
import re

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk
from sdr_channelizer_tpu_torch.ops.medians import masked_median

torch.set_num_threads(1)

_SRC = os.path.join(os.path.dirname(psk.__file__), "csrc", "pulse_stats.cu")


def _constant(name: str) -> int:
    with open(_SRC) as f:
        text = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1), {}, {"kTile": 128, "kChunk": 32}))


TILE, CHUNK = _constant("kTile"), _constant("kChunk")
SHORT, STRETCH = _constant("kShortKeys"), _constant("kStretch")
CLASSES = (8, 16, 32, 64, 128)       # class_of in the source
PER_UNIT = {8: 4, 16: 2, 32: 1, 64: 1, 128: 1}
NAN_KEY = np.uint32(0xFFFFFFFF)


def test_model_constants_are_the_wrappers():
    assert (TILE, SHORT, STRETCH) == (psk.TILE, psk.SHORT_KEYS,
                                      psk.BLOCK_KEYS)
    assert TILE % CHUNK == 0 and CLASSES[-1] == SHORT


# ------------------------------------------------------------------ keys

def keys_of(x: np.ndarray) -> np.ndarray:
    """``sdr::key_of``: the sort's order, every NaN above +inf."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32)
    k = np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), NAN_KEY, k).astype(np.uint32)


def f32_of(k) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    raw = np.where(k >> 31, k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32)
    return raw.view(np.float32)


def mean_of(lo, hi) -> np.float32:
    with np.errstate(invalid="ignore", over="ignore"):
        return np.float32(np.float32(0.5) * (f32_of(lo) + f32_of(hi)))


# ------------------------------------------------------- the short runs

def warp_sort(k: np.ndarray, w: int) -> np.ndarray:
    """``warp_sort<R, W>``: k is (R, 32), key r*32+lane at k[r, lane]."""
    k = k.copy()
    r_n = k.shape[0]
    lane = np.arange(32)
    e = np.arange(r_n)[:, None] * 32 + lane
    size = 2
    while size <= w:
        stride = size // 2
        while stride > 0:
            up = (size == w) | ((e & size) == 0)
            if stride >= 32:
                rs = stride // 32
                new = k.copy()
                for r in range(r_n):
                    rp = r ^ rs
                    if rp > r:
                        lo = np.minimum(k[r], k[rp])
                        hi = np.maximum(k[r], k[rp])
                        new[r] = np.where(up[r], lo, hi)
                        new[rp] = np.where(up[r], hi, lo)
                k = new
            else:
                other = k[:, lane ^ stride]
                lower = (lane & stride) == 0
                k = np.where(lower == up, np.minimum(k, other),
                             np.maximum(k, other))
            stride //= 2
        size *= 2
    return k


def warp_unit(runs, w: int):
    """``stats_unit<W>`` for one stream: the medians of up to 32 / W runs
    of at most W samples (W <= 32), or of one run (W = 64, 128)."""
    r_n = max(1, w // 32)
    lanes = min(w, 32)
    k = np.full((r_n, 32), NAN_KEY, np.uint32)
    for g, run in enumerate(runs):
        assert len(run) <= w
        kk = keys_of(run)
        for i, key in enumerate(kk):
            k[i // 32, g * lanes + i % 32] = key
    s = warp_sort(k, w).reshape(-1, order="C")
    flat = lambda i: s[(i // 32) * 32 + i % 32]  # noqa: E731
    out = []
    for g, run in enumerate(runs):
        n = len(run)
        if n == 0:
            out.append(np.float32(np.nan))
            continue
        at = g * lanes
        lo = flat(at + (n - 1) // 2) if w <= 32 else s[(n - 1) // 2]
        hi = flat(at + n // 2) if w <= 32 else s[n // 2]
        out.append(mean_of(lo, hi))
    return out


# ------------------------------------------------------- the longer runs

def find_bins(hist: np.ndarray, ra: int, rb: int):
    """``find_bins``: ra's bin, the count below it, its count, rb's bin."""
    cum = np.cumsum(hist)
    a = int(np.searchsorted(cum, ra, side="right"))
    b = int(np.searchsorted(cum, rb, side="right"))
    return a, int(cum[a] - hist[a]), int(hist[a]), b


def block_median(x: np.ndarray):
    """``block_median``: the median of a run and how it was found."""
    keys = keys_of(x)
    n = len(keys)
    info = {"reads": 1 if n <= STRETCH else 2, "buffer": None,
            "parted": None}
    if n == 0:
        return np.float32(np.nan), info
    k_lo, k_hi = (n - 1) // 2, n // 2
    top = keys >> 20
    a0, below, c_a, b0 = find_bins(np.bincount(top, minlength=4096), k_lo,
                                   k_hi)
    rank, d, pref = k_lo - below, k_hi - k_lo, np.uint32(a0 << 20)
    parted = -1 if a0 == b0 else 0
    hi_min = keys[top == b0].min() if parted == 0 else None
    if n <= STRETCH:           # the run kept in shared memory
        src = keys
        info["buffer"] = "run"
    else:                      # read again: lo's 12-bit bin compacted
        src = keys[top == a0]
        assert len(src) == c_a
        info["buffer"] = "shared" if c_a <= STRETCH else "scratch"
    sel = src[(src >> 20) == a0]
    h1 = np.bincount((sel >> 10) & 1023, minlength=1024)
    a1, below1, _, b1 = find_bins(h1, rank, rank + (d if parted < 0 else 0))
    rank -= below1
    if parted < 0 and b1 != a1:
        parted = 1
        hi_pref = pref | np.uint32(b1 << 10)
        hi_min = src[(src & np.uint32(0xFFFFFC00)) == hi_pref].min()
    pref = pref | np.uint32(a1 << 10)
    sel2 = src[(src & np.uint32(0xFFFFFC00)) == pref]
    h2 = np.bincount(sel2 & 1023, minlength=1024)
    a2, _, _, b2 = find_bins(h2, rank, rank + (d if parted < 0 else 0))
    if parted < 0 and b2 != a2:
        parted = 2
    lo = pref | np.uint32(a2)
    hi = pref | np.uint32(b2) if parted in (-1, 2) else hi_min
    info["parted"] = parted
    return mean_of(lo, hi), info


# ------------------------------------------------------------ the triage

def run_of(toa, te, window, t_len, s):
    i0 = int(toa[s])
    if not 0 <= i0 < t_len:
        return None
    plen = min(int(te[s]) - i0 + 1, window)
    n_mag = max(min(i0 + plen, t_len) - i0, 0)
    n_dph = max(min(i0 + plen - 1, t_len) - i0, 0)
    return i0, n_mag, n_dph


def class_of(n: int) -> int:
    return next(w for w in CLASSES if n <= w)


def triage(toa, te, window, t_len, chunks):
    """The chunk kernel's first warp on each chunk: ``(dead, units, big)``,
    the dead slots, the warps' units ``(W, slots)`` and the select
    kernel's list."""
    dead, units, big = [], [], []
    n_slots = len(toa)
    for c in chunks:
        by_class = {w: [] for w in CLASSES}
        for s in range(c * CHUNK, min((c + 1) * CHUNK, n_slots)):
            r = run_of(toa, te, window, t_len, s)
            if r is None:
                dead.append(s)
            elif r[1] <= SHORT:
                by_class[class_of(r[1])].append(s)
            else:
                big.append(s)
        for w in CLASSES:
            lst, g = by_class[w], PER_UNIT[w]
            units += [(w, lst[i:i + g]) for i in range(0, len(lst), g)]
    return dead, units, big


def model_stats(mag, dph, sat, toa, te, rows, window, t_len, chunks=None):
    """K4 (all chunks) or B10 (``chunks``: those of the live tiles) as the
    model runs them; flat slot lists, ``rows`` each slot's row."""
    n_slots = len(toa)
    if chunks is None:
        chunks = range(-(-n_slots // TILE) * (TILE // CHUNK))
    dead, units, big = triage(toa, te, window, t_len, chunks)
    out = [np.zeros(n_slots, np.float32) for _ in range(3)]

    def streams(s):
        i0, n_mag, n_dph = run_of(toa, te, window, t_len, s)
        row = int(rows[s])
        return (mag[row, i0:i0 + n_mag], dph[row, i0:i0 + n_dph],
                sat[row, i0 + 1:i0 + n_dph] if n_dph > 1 else sat[row, :0])

    for w, slots in units:
        runs = [streams(s) for s in slots]
        for j, stream in enumerate((0, 1)):
            meds = warp_unit([r[stream] for r in runs], w)
            for s, med in zip(slots, meds):
                out[j][s] = med
        for s, r in zip(slots, runs):
            out[2][s] = np.float32(bool((r[2] > 0.5).any()))
    infos = {}
    for s in big:
        m, d, sa = streams(s)
        out[0][s], infos[(s, 0)] = block_median(m)
        out[1][s], infos[(s, 1)] = block_median(d)
        out[2][s] = np.float32(bool((sa > 0.5).any()))
    return out, {"dead": dead, "units": units, "big": big, "infos": infos}


def nan_high_median(x: np.ndarray) -> np.float32:
    """The median with every NaN above +inf (numpy's sort does that)."""
    if len(x) == 0:
        return np.float32(np.nan)
    s = np.sort(np.asarray(x, np.float32))
    return mean_of(keys_of(s[(len(s) - 1) // 2]), keys_of(s[len(s) // 2]))


# ------------------------------------------------------------ the inputs

SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.2e-39, -3.4e-40]
    + [np.uint32(b).view(np.float32)
       for b in (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345)],
    dtype=np.float32)


def run_kind(kind: str, n: int, rng) -> np.ndarray:
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "constant":
        return np.full(n, 0.5, np.float32)
    if kind == "ties":      # ties across the middle
        return (np.round(rng.standard_normal(n) * 2) / 2).astype(np.float32)
    if kind == "one_bin":   # nearly equal: one 12-bit bin, [0.75, 0.8125)
        return (0.78 + 1e-4 * rng.standard_normal(n)).astype(np.float32)
    if kind == "zeros":     # +-0.0, subnormals and +-inf
        return rng.choice(SPECIALS[:8], n)
    if kind == "sprinkled":  # a few NaNs of both signs among numbers
        x = rng.standard_normal(n).astype(np.float32)
        m = rng.random(n) < 0.05
        x[m] = rng.choice(SPECIALS, int(m.sum()))
        return x
    if kind == "nan_heavy":  # NaNs of both signs reach the middle
        x = rng.standard_normal(n).astype(np.float32)
        m = rng.random(n) < 0.6
        x[m] = rng.choice(SPECIALS[-4:], int(m.sum()))
        return x
    raise ValueError(kind)


KINDS = ("normal", "constant", "ties", "one_bin", "zeros", "sprinkled",
         "nan_heavy")
LENGTHS = (0, 1, 2, 3, 7, 8, 9, 16, 17, 31, 32, 33, 64, 65, 127, 128, 129,
           130, 1000, STRETCH - 1, STRETCH, STRETCH + 1, STRETCH + 2, 20000)


@pytest.mark.parametrize("kind", KINDS)
def test_every_class_boundary_gives_the_sort_with_nans_high(kind):
    """Each length class and one either side of its boundary, through the
    path the kernel takes for it, is the median of a sort with NaNs high."""
    rng = np.random.default_rng(KINDS.index(kind))
    for n in LENGTHS:
        x = run_kind(kind, n, rng)
        want = nan_high_median(x)
        if n <= SHORT:
            got = warp_unit([x], class_of(max(n, 1)))[0]
        else:
            got, _ = block_median(x)
        assert got == want or (np.isnan(got) and np.isnan(want)), (kind, n)


@pytest.mark.parametrize("w", CLASSES[:2])
def test_a_warp_takes_several_short_runs_at_once(w):
    """Runs of one class share a warp, one segment of W lanes each; the
    segments' last merges all ascend."""
    rng = np.random.default_rng(w)
    runs = [run_kind("sprinkled", int(rng.integers(0, w + 1)), rng)
            for _ in range(PER_UNIT[w])]
    got = np.array(warp_unit(runs, w), np.float32)
    assert _agree(got, np.array([nan_high_median(r) for r in runs])).all()


@pytest.mark.parametrize("kind, n, buffer", [
    ("normal", STRETCH, "run"), ("normal", STRETCH + 1, "shared"),
    ("one_bin", STRETCH + 1, "scratch"), ("constant", 20000, "scratch"),
    ("normal", 20000, "shared"), ("ties", 20000, "shared"),
])
def test_a_long_run_is_read_twice_and_compacted_where_it_fits(kind, n,
                                                              buffer):
    rng = np.random.default_rng(n)
    x = run_kind(kind, n, rng)
    got, info = block_median(x)
    assert info["reads"] == (1 if n <= STRETCH else 2)
    assert info["buffer"] == buffer
    assert got == nan_high_median(x)


@pytest.mark.parametrize("parted, hi", [
    (-1, 1.0),                 # hi follows lo to the last digit
    (0, 4.0),                  # hi's 12-bit bin is another
    (1, 1.0 + 2.0 ** -10),     # they part at key bits [19:10]
    (2, 1.0 + 2.0 ** -20),     # they part at key bits [9:0]
])
@pytest.mark.parametrize("n_half", [STRETCH // 2, STRETCH])
def test_the_upper_middle_parts_at_each_digit(parted, hi, n_half):
    """An even run, half 1.0 and half ``hi``, read once and read twice."""
    x = np.concatenate([np.full(n_half, 1.0, np.float32),
                        np.full(n_half, hi, np.float32)])
    np.random.default_rng(n_half).shuffle(x)
    got, info = block_median(x)
    assert info["parted"] == parted
    assert info["reads"] == (1 if 2 * n_half <= STRETCH else 2)
    assert got == nan_high_median(x) == np.float32(0.5) * np.float32(1 + hi)


def _crafted(seed: int, m: int = 4, t_arr: int = 30_000, t_len: int = 29_990):
    """Streams with every kind of run, slots at every class boundary, cut
    at t_len, dead and random ones."""
    rng = np.random.default_rng(seed)
    kinds = ("sprinkled", "ties", "one_bin", "zeros")
    mag = np.stack([run_kind(kinds[c % 4], t_arr, rng) for c in range(m)])
    dph = np.stack([run_kind(kinds[(c + 1) % 4], t_arr, rng)
                    for c in range(m)])
    sat = (rng.random((m, t_arr)) < 0.01).astype(np.float32)
    p = 48
    toa = np.full((m, p), t_len, np.int32)
    te = np.full((m, p), t_len, np.int32)
    lengths = [n for n in LENGTHS if n <= 10_000]
    for c in range(m):
        for j, n in enumerate(lengths):
            toa[c, j] = rng.integers(0, t_len - n)
            te[c, j] = toa[c, j] + n - 1
        k = len(lengths)
        toa[c, k:k + 4] = [t_len - 50, t_len - 1, -1, t_len]
        te[c, k:k + 4] = [t_len + 449, t_len + 5, 10, t_len]
        for j in range(k + 4, p - 4):
            toa[c, j] = rng.integers(0, t_len - 1)
            te[c, j] = toa[c, j] + int(rng.choice([2, 5, 12, 40, 100, 300]))
    return mag, dph, sat, toa, te, t_len


def _agree(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("window", [128, 1024, STRETCH, 65536])
@pytest.mark.parametrize("form", ["grid", "dense"])
def test_model_matches_plain_version(window, form):
    """The model against ``pulse_stats_plain`` / ``pulse_stats_dense_plain``
    on the crafted runs, every output and slot, with the mask; where NaNs
    reach a run's middle ranks the plain version's +inf padding sorts
    below them, and there the model is the sort with NaNs high."""
    mag, dph, sat, toa, te, t_len = _crafted(window)
    m, p = toa.shape
    rows = np.repeat(np.arange(m), p)
    tm, td, ts = (torch.from_numpy(x) for x in (mag, dph, sat))
    if form == "grid":
        plain = psk.pulse_stats_plain(tm, td, torch.from_numpy(toa),
                                      torch.from_numpy(te), window, t_len, ts)
        plain = [x.numpy().reshape(-1) for x in plain]
        t_f, e_f = toa.reshape(-1), te.reshape(-1)
    else:
        perm = np.random.default_rng(1).permutation(m * p)
        t_f, e_f, rows = toa.reshape(-1)[perm], te.reshape(-1)[perm], \
            rows[perm]
        plain = psk.pulse_stats_dense_plain(
            tm, td, ts, torch.from_numpy(t_f), torch.from_numpy(e_f),
            torch.from_numpy(rows.astype(np.int32)), window, t_len)
        plain = [x.numpy() for x in plain]
    got, _ = model_stats(mag, dph, sat, t_f, e_f, rows, window, t_len)
    np.testing.assert_array_equal(got[2], plain[2])
    for j, stream in enumerate((mag, dph)):
        want = np.zeros_like(got[j])
        for s in range(len(t_f)):
            r = run_of(t_f, e_f, window, t_len, s)
            if r is not None:
                want[s] = nan_high_median(stream[rows[s], r[0]:r[0] + r[1 + j]])
        assert _agree(got[j], want).all()
        same = _agree(plain[j], want)
        assert _agree(got[j], plain[j])[same].all()
        # where they differ, the plain version answers +inf for the NaN
        assert (np.isinf(plain[j][~same]) & np.isnan(want[~same])).all()


def _tiers(seed: int, m: int = 6, p: int = 96, t_len: int = 5000):
    """A slot grid and the two tier selects of the statistics tail (short:
    closed, 3-128 samples, window 128; long: the rest of the live slots,
    window 1024), dead slots at the sentinel t_len."""
    rng = np.random.default_rng(seed)
    toa = np.full((m, p), t_len, np.int32)
    te = np.full((m, p), t_len, np.int32)
    for c in range(m):
        k = int(rng.integers(0, p))
        toa[c, :k] = np.sort(rng.integers(0, t_len, k))
        te[c, :k] = toa[c, :k] + rng.integers(0, 1500, k)
    te = np.minimum(te, t_len).astype(np.int32)
    plen = te - toa + 1
    closed = (toa < t_len) & (te < t_len)
    tiny = closed & (plen <= 2)
    short = closed & ~tiny & (plen <= 128)
    long_ = (toa < t_len) & ~tiny & ~short
    return [(np.where(s, toa, t_len).astype(np.int32),
             np.where(s, te, t_len).astype(np.int32), w)
            for s, w in ((short, 128), (long_, 1024))], t_len


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tier", [0, 1], ids=["short", "long"])
@pytest.mark.parametrize("form", ["grid", "dense"])
def test_triage_covers_every_live_slot_once(seed, tier, form):
    """The chunk kernel's lists, walked over all chunks: every live slot
    in exactly one warp's unit or in the select kernel's list, each where
    its length puts it, and every dead slot written 0."""
    (t_s, e_s, w), t_len = _tiers(seed)[0][tier], _tiers(seed)[1]
    t_f, e_f = t_s.reshape(-1), e_s.reshape(-1)
    if form == "dense":
        perm = np.random.default_rng(seed).permutation(t_f.size)
        t_f, e_f = t_f[perm], e_f[perm]
    chunks = range(-(-t_f.size // TILE) * (TILE // CHUNK))
    dead, units, big = triage(t_f, e_f, w, t_len, chunks)
    live = np.flatnonzero((t_f >= 0) & (t_f < t_len))
    seen = [s for _, slots in units for s in slots] + big
    assert sorted(seen) == list(live) and len(seen) == len(set(seen))
    assert sorted(dead + seen) == list(range(t_f.size))
    for wc, slots in units:
        assert len(slots) <= PER_UNIT[wc]
        for s in slots:
            assert class_of(run_of(t_f, e_f, w, t_len, s)[1]) == wc
    for s in big:
        assert run_of(t_f, e_f, w, t_len, s)[1] > SHORT
    assert tier == 1 or not big      # the short tier never needs a block


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nt", [2, 3, 8])
def test_b10_list_of_live_tiles_gives_the_same_slots(seed, nt):
    """B10's blocks over the list of live tiles (built by ``_live_tiles``
    on CPU tensors), a quarter tile each: the same live slots as K4's
    chunks, each once, and the same statistics."""
    (t_s, e_s, w), t_len = _tiers(seed, p=300)[0][0], _tiers(seed, p=300)[1]
    t_f, e_f = t_s.reshape(-1), e_s.reshape(-1)
    ids, n_live, n_batches = psk._live_tiles(torch.from_numpy(t_f), t_len, nt)
    ids, n_live = ids.numpy(), int(n_live)
    per = TILE // CHUNK
    chunks = [int(ids[b // per]) * per + b % per
              for b in range(n_batches * nt * per) if b // per < n_live]
    _, units, big = triage(t_f, e_f, w, t_len, chunks)
    seen = sorted([s for _, slots in units for s in slots] + big)
    assert seen == list(np.flatnonzero((t_f >= 0) & (t_f < t_len)))
    rng = np.random.default_rng(seed)
    mag = rng.standard_normal((6, t_len)).astype(np.float32)
    sat = (rng.random((6, t_len)) < 0.02).astype(np.float32)
    rows = np.repeat(np.arange(6), t_s.shape[1])
    k4, _ = model_stats(mag, mag, sat, t_f, e_f, rows, w, t_len)
    b10, _ = model_stats(mag, mag, sat, t_f, e_f, rows, w, t_len, chunks)
    for a, b in zip(k4, b10):
        assert _agree(a, b).all()


def test_masked_median_orders_every_nan_high():
    """The plain versions' median puts NaNs of both signs above every
    number; on the card ``torch.sort`` alone would put a negative NaN
    lowest where it sorts by radix."""
    neg_nan = np.uint32(0xFFC00000).view(np.float32)
    x = torch.tensor([[1.0, neg_nan, 2.0, 0.5], [neg_nan, 3.0, 1.0, 2.0]])
    got = masked_median(x, torch.ones_like(x, dtype=torch.bool)).numpy()
    assert got[0] == 1.5 and got[1] == 2.5
    assert got[0] == nan_high_median(x[0].numpy())
