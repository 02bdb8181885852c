"""The select that the noise floor kernel (K2, ``csrc/noise_floor.cu``) runs
on the card, modelled in NumPy and held bit for bit against the port's
``noise_floor_cm_plain``, the JAX package's ``pallas_noise_floor_cm`` (in
interpret mode) and its ``medians.median``.

The kernel selects on order-preserving u32 keys (every NaN above +inf),
one digit at a time: bits [31:20], [19:12], [11:0].  Each row's histogram of
a digit is the sum of per-chunk histograms (one per block); a pick finds the
bins that hold the ranks of lo ((t_len - 1) // 2) and hi (t_len // 2).  A
sample of the row (64 runs of 128 values) names a window of 12-bit bins;
the first pass compacts the window's keys into a buffer of ``cap`` keys a
row, and where the window held lo's bin (and hi's) and nothing overflowed,
the next digits are read from the buffer.  Else the row is read again: its
keys of lo's 12-bit prefix are compacted where they fit, or the next digits
come from the row itself.  Where a pick puts hi's rank in a later bin than
lo's, hi is the least key of that bin, taken in a later pass (at the last
digit the bin is the key).  The model lives in this file, not in the
package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.ops.pallas.nf_kernel import pallas_noise_floor_cm
from sdr_channelizer_tpu_torch.ops import medians as tmedians
from sdr_channelizer_tpu_torch.ops.cuda.nf_kernel import noise_floor_cm_plain

torch.set_num_threads(1)

SHIFTS = (20, 12, 0)
BINS = (4096, 256, 4096)
KNOWN = (0, 0xFFF00000, 0xFFFFF000, 0xFFFFFFFF)  # bits known before a digit
KERNEL_CHUNK = 512 * 16   # values a block reads at a time
SAMPLE_RUNS, SAMPLE_RUN = 64, 128


def kernel_cap(t_len):
    """The buffer's keys a row (``sdr_noise_floor_cap``)."""
    return (t_len // 4 + 1 + 3) // 4 * 4


def keys_of(x):
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    k = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), k)


def f32_of(k):
    k = np.uint32(k)
    raw = k & np.uint32(0x7FFFFFFF) if k >> 31 else ~k
    return np.array([raw], np.uint32).view(np.float32)[0]


def carry(src, level, want):
    return src[(src & np.uint32(KNOWN[level])) == np.uint32(want)]


def histogram(src, level, want, chunk):
    """The row's histogram of the digit of ``level`` over the keys that
    carry ``want``: one per chunk, merged."""
    total = np.zeros(BINS[level], np.int64)
    for c0 in range(0, len(src), chunk):
        part = carry(src[c0:c0 + chunk], level, want)
        total += np.bincount((part >> SHIFTS[level]) & (BINS[level] - 1),
                             minlength=BINS[level])
    return total


def pick(hist, rank):
    """The bin that holds ``rank`` and the count below it."""
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, rank, side="right"))
    return b, int(cum[b] - hist[b])


def least(src, level, want, chunk):
    """The least key that carries ``want``: one min per chunk, merged."""
    mins = [carry(src[c0:c0 + chunk], level, want) for c0 in
            range(0, len(src), chunk)]
    return min(int(m.min()) for m in mins if m.size)


def sample_window(row):
    """The 12-bit bins in which the kernel's sample of ``row`` puts the ranks
    of lo and hi, widened by six standard deviations of a sample quantile."""
    t_len = len(row)
    n = SAMPLE_RUNS * SAMPLE_RUN
    if t_len <= n:
        sample, n, margin = row, t_len, 0
    else:
        i = np.arange(n)
        at = (i // SAMPLE_RUN) * (t_len - SAMPLE_RUN) // (SAMPLE_RUNS - 1) \
            + i % SAMPLE_RUN
        sample, margin = row[at], int(6.0 * np.sqrt(0.25 * n)) + 8
    hist = np.bincount(sample >> 20, minlength=4096)
    a = max(0, (t_len - 1) // 2 * n // t_len - margin)
    b = min(n - 1, -(-(t_len // 2) * n // t_len) + margin)
    return pick(hist, a)[0], pick(hist, b)[0]


def select_row(row, chunk, cap, window=None):
    """The median of one row of keys by the kernel's passes, and where the
    buffer was filled: ``"pass0"`` (the window's bins held lo's and hi's),
    ``"pass1"`` (the row read again and its prefix compacted) or ``"row"``
    (the prefix's keys did not fit: the digits come from the row)."""
    t_len = len(row)
    w_lo, w_hi = sample_window(row) if window is None else window
    rank = (t_len - 1) // 2
    hi_off = t_len // 2 - rank
    hi = None          # hi's key once it no longer follows lo
    hi_split = None    # (level after the split, hi's bits)
    prefix, src, filled = 0, row, None
    for level in range(3):
        if level == 1:
            parts = [row[c0:c0 + chunk] for c0 in range(0, t_len, chunk)]
            windowed = np.concatenate(
                [p[((p >> 20) >= w_lo) & ((p >> 20) <= w_hi)] for p in parts])
            bin0 = prefix >> 20
            hi_bin = None if hi_split is None else hi_split[1] >> 20
            if (len(windowed) <= cap and w_lo <= bin0 <= w_hi
                    and (hi_bin is None or hi_bin <= w_hi)):
                filled, src = "pass0", windowed
            elif int(histogram(row, 0, 0, chunk)[bin0]) <= cap:
                filled = "pass1"
                src = np.concatenate([carry(p, 1, prefix) for p in parts])
            else:
                filled = "row"
        if hi_split is not None and hi_split[0] == level:
            # the pass after the split: the least key of hi's bin, from the
            # buffer where it holds them, else from the row
            hi = least(src if filled != "row" else row, level, hi_split[1],
                       chunk)
            hi_split = None
        h = histogram(src, level, prefix, chunk)
        b_lo, below = pick(h, rank)
        if hi is None and hi_split is None and hi_off:
            b_hi, _ = pick(h, rank + hi_off)
            if b_hi != b_lo:
                bits = prefix | (b_hi << SHIFTS[level])
                if level == 2:
                    hi = bits
                else:
                    hi_split = (level + 1, bits)
        prefix |= b_lo << SHIFTS[level]
        rank -= below
    lo = f32_of(prefix)
    hi = lo if hi is None else f32_of(hi)
    return np.float32(0.5) * (lo + hi), filled


def select_median(mag, t_len, chunk=KERNEL_CHUNK, cap=None, window=None):
    """(R,) float32 medians of the first ``t_len`` columns, and where each
    row's buffer was filled."""
    cap = kernel_cap(t_len) if cap is None else cap
    if t_len == 0:
        return np.full(mag.shape[0], np.nan, np.float32), []
    out, filled = [], []
    for r in range(mag.shape[0]):
        v, how = select_row(keys_of(mag[r, :t_len]), chunk, cap, window)
        out.append(v)
        filled.append(how)
    return np.array(out, np.float32), filled


def _mag(kind, rows=8, t=3001):
    rng = np.random.default_rng(17)
    x = np.hypot(rng.standard_normal((rows, t)),
                 rng.standard_normal((rows, t))).astype(np.float32)
    if kind == "equal":
        x[:] = 0.375
    elif kind == "quantized":
        x = np.round(x)   # a few integers: the median's bin holds most
    elif kind == "dup_boundary":
        # lo's value repeated up to the rank boundary, hi's value just past
        x[:, : t // 2] = 0.5
        x[:, t // 2:] = np.nextafter(np.float32(0.5), np.float32(1))
    elif kind == "adjacent_bins":
        # lo and hi in neighbouring bins of the first digit
        x[:, : t // 2] = 1.0
        x[:, t // 2:] = 1.5
    elif kind == "split_in_window":
        # lo and hi in neighbouring 12-bit bins, each holding few keys: the
        # window holds both, hi is the least key of its bin
        x[:, : t // 2] = np.linspace(0.01, 0.99, t // 2)
        x[:, t // 2:] = np.linspace(1.01, 100.0, t - t // 2)
    elif kind == "mid_bins":
        # lo and hi in neighbouring bins of the second digit
        one = np.float32(1.0).view(np.uint32)
        x[:, : t // 2] = 1.0
        x[:, t // 2:] = np.uint32(one + (1 << 12)).view(np.float32)
    elif kind == "denormal":
        x = (x * 1e-39).astype(np.float32)
        assert np.all(x[x > 0] < np.finfo(np.float32).tiny)
    elif kind == "nan":
        x[:, ::5] = np.nan
    elif kind == "nan_most":
        x[:, : 2 * t // 3] = np.nan
    elif kind == "signed":
        x = rng.standard_normal((rows, t)).astype(np.float32)
    return x.astype(np.float32)


KINDS = ["rayleigh", "equal", "quantized", "dup_boundary", "adjacent_bins",
         "split_in_window", "mid_bins", "denormal", "nan", "nan_most",
         "signed"]
T_LENS = [3001, 3000, 2, 1, 0]


@pytest.mark.parametrize("t_len", T_LENS)
@pytest.mark.parametrize("kind", KINDS)
def test_select_equals_the_plain_median(kind, t_len):
    mag = _mag(kind)
    want = noise_floor_cm_plain(torch.from_numpy(mag), t_len).numpy()
    for chunk in (KERNEL_CHUNK, 97):
        got, _ = select_median(mag, t_len, chunk=chunk)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rayleigh", "quantized", "equal",
                                  "adjacent_bins"])
@pytest.mark.parametrize("cap", [8, 64])
def test_overflowing_buffer_reads_the_row_again(kind, cap):
    """A buffer too small for the prefix's keys: the digits come from the
    row, with the same bits."""
    mag = _mag(kind, rows=4, t=20000)   # longer than the sample
    want = noise_floor_cm_plain(torch.from_numpy(mag), 20000).numpy()
    got, filled = select_median(mag, 20000, chunk=997, cap=cap)
    assert set(filled) == {"row"}
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rayleigh", "adjacent_bins", "mid_bins"])
@pytest.mark.parametrize("window", [(0, 0), (4095, 4095), (0, 2047)])
def test_a_window_that_misses_reads_the_row_again(kind, window):
    """A window that does not hold lo's bin or hi's: the row is read again
    (its prefix compacted where it fits the buffer, as noise does), with the
    same bits."""
    mag = _mag(kind)
    want = noise_floor_cm_plain(torch.from_numpy(mag), 3000).numpy()
    got, filled = select_median(mag, 3000, chunk=97, window=window)
    assert set(filled) == ({"pass1"} if kind == "rayleigh" else {"row"})
    np.testing.assert_array_equal(got, want)


def test_the_sample_holds_noise_and_quantized_rows_overflow():
    """At the kernel's sample and cap a row of noise is read once (the path
    the floors take), the keys of a quantized row's median bin do not fit."""
    mag = _mag("rayleigh", t=50000)
    got, filled = select_median(mag, 50000)
    assert set(filled) == {"pass0"}
    np.testing.assert_array_equal(
        got, noise_floor_cm_plain(torch.from_numpy(mag), 50000).numpy())
    _, filled = select_median(_mag("quantized", t=50000), 50000)
    assert set(filled) == {"row"}


def test_hi_split_off_inside_the_window_is_read_from_the_buffer():
    mag = _mag("split_in_window")
    got, filled = select_median(mag, 3000)
    assert set(filled) == {"pass0"}
    np.testing.assert_array_equal(
        got, noise_floor_cm_plain(torch.from_numpy(mag), 3000).numpy())
    assert got[0] == np.float32(0.5) * (np.float32(0.99) + np.float32(1.01))


def test_negative_nan_sorts_high():
    mag = _mag("rayleigh", rows=2, t=11)
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    mag[:, :7] = neg_nan
    want = noise_floor_cm_plain(torch.from_numpy(mag), 11).numpy()
    got, _ = select_median(mag, 11, chunk=3)
    assert np.isnan(want).all()
    np.testing.assert_array_equal(got, want)


def test_one_dimensional_row():
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal(50_001)).astype(np.float32)
    want = noise_floor_cm_plain(torch.from_numpy(x)[None], x.size).numpy()
    got, filled = select_median(x[None], x.size)
    np.testing.assert_array_equal(got, want)
    assert filled == ["pass0"]
    assert got[0] == np.float32(jmedians.median(jnp.asarray(x)))


# The JAX package on the CPU flushes subnormals to zero and returns NaN for
# a row that holds one (``jnp.median``); the port sorts NaNs high, as
# ``noise_floor_cm_plain`` and the port's ``medians.median`` do.  Those two
# cases are held against the port's medians (above and below).
JAX_KINDS = ["rayleigh", "quantized", "dup_boundary", "adjacent_bins",
             "split_in_window", "mid_bins", "equal", "signed"]


@pytest.fixture(scope="module")
def jax_kernel():
    """The JAX package's kernel on each case (interpret mode), t_len 1001
    and 1000 of 1024 columns."""
    out = {}
    for kind in JAX_KINDS:
        mag = _mag(kind, rows=8, t=1024)
        for t_len in (1001, 1000):
            out[kind, t_len] = (mag, np.asarray(pallas_noise_floor_cm(
                jnp.asarray(mag), t_len=t_len, interpret=True)))
    return out


@pytest.mark.parametrize("t_len", [1001, 1000])
@pytest.mark.parametrize("kind", JAX_KINDS)
def test_select_equals_the_jax_kernel_and_median(jax_kernel, kind, t_len):
    mag, ref = jax_kernel[kind, t_len]
    got, _ = select_median(mag, t_len, chunk=97)
    np.testing.assert_array_equal(got, ref)
    med = np.asarray(jmedians.median(jnp.asarray(mag[:, :t_len]), axis=1))
    np.testing.assert_array_equal(got, med)


@pytest.mark.parametrize("kind", ["nan", "nan_most", "denormal"])
def test_select_equals_the_ports_median(kind):
    mag = _mag(kind)
    got, _ = select_median(mag, 3000, chunk=97)
    med = tmedians.median(torch.from_numpy(mag[:, :3000]), dim=1).numpy()
    np.testing.assert_array_equal(got, med)
