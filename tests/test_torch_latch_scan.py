"""The decomposition that the time-major latch kernel (``latch_tm_kernel``)
runs on the card, modelled in plain PyTorch and held against the port's
``latch_cumsums_plain`` bit for bit, and once against the JAX package's
``pallas_latch_cumsums``.

The kernel cuts time into segments and carries, from segment to segment, a
summary that does not depend on the state the segment enters in: ``f`` its
first non-hold transfer, ``l`` its last (0 if none), ``L`` / ``R`` the
leading and trailing edges strictly after the position of ``f``.  The model
here computes the summaries, chains them with the composition, applies each
exclusive prefix to the entry state and walks every segment from the state
and counts it gives.  The model lives in this file, not in the package."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.latch_kernel import pallas_latch_cumsums
from sdr_channelizer_tpu_torch.ops.cuda.latch_kernel import latch_cumsums_plain

torch.set_num_threads(1)

NONE = (0, 0, 0, 0)


def compose(a, b):
    """Summary of segment A followed by segment B (tuples or tensors)."""
    af, al, a_lead, a_trail = a
    bf, bl, b_lead, b_trail = b
    if isinstance(af, torch.Tensor):
        f = torch.where(af != 0, af, bf)
        l_ = torch.where(bl != 0, bl, al)
        edge_l = ((al == -1) & (bf == 1)).to(a_lead.dtype)
        edge_t = ((al == 1) & (bf == -1)).to(a_lead.dtype)
    else:
        f = af if af else bf
        l_ = bl if bl else al
        edge_l = int(al == -1 and bf == 1)
        edge_t = int(al == 1 and bf == -1)
    return f, l_, a_lead + b_lead + edge_l, a_trail + b_trail + edge_t


def summaries(tr):
    """(f, l, L, R) of each segment of ``tr`` (n_seg, S, M) int64."""
    s = tr.shape[1]
    pos = torch.arange(s).view(1, s, 1).expand_as(tr)
    nz = tr != 0
    first = torch.where(nz, pos, torch.full_like(pos, s)).min(dim=1).values
    last = torch.where(nz, pos, torch.full_like(pos, -1)).max(dim=1).values
    f = torch.where(first < s, torch.gather(tr, 1, first.clamp(max=s - 1)
                                            .unsqueeze(1)).squeeze(1), 0)
    l_ = torch.where(last >= 0, torch.gather(tr, 1, last.clamp(min=0)
                                             .unsqueeze(1)).squeeze(1), 0)
    # the non-hold transfer before each sample, inside the segment
    prev_pos = torch.cummax(torch.where(nz, pos, torch.full_like(pos, -1)),
                            dim=1).values
    prev_pos = torch.cat([torch.full_like(prev_pos[:, :1], -1),
                          prev_pos[:, :-1]], dim=1)
    prev = torch.where(prev_pos >= 0,
                       torch.gather(tr, 1, prev_pos.clamp(min=0)), 0)
    lead = ((prev == -1) & (tr == 1)).sum(dim=1)
    trail = ((prev == 1) & (tr == -1)).sum(dim=1)
    return f, l_, lead, trail


def apply(prefix, state, lead, trail):
    """Counts and state after a prefix, entered in ``state``."""
    f, l_, n_lead, n_trail = prefix
    lead = lead + n_lead + ((state == 0) & (f == 1)).to(lead.dtype)
    trail = trail + n_trail + ((state == 1) & (f == -1)).to(trail.dtype)
    state = torch.where(l_ != 0, (l_ > 0).to(state.dtype), state)
    return state, lead, trail


def walk(tr, state, lead, trail):
    """Inclusive counts of each segment's samples from its entry state and
    base counts: (n_seg, S, M) each."""
    s = tr.shape[1]
    pos = torch.arange(s).view(1, s, 1).expand_as(tr)
    last = torch.cummax(torch.where(tr != 0, pos, torch.full_like(pos, -1)),
                        dim=1).values
    picked = torch.gather(tr, 1, last.clamp(min=0)) > 0
    st_ = torch.where(last >= 0, picked, state.unsqueeze(1) > 0).to(torch.int64)
    prev = torch.cat([state.unsqueeze(1), st_[:, :-1]], dim=1)
    le = torch.cumsum(st_ * (1 - prev), dim=1) + lead.unsqueeze(1)
    te = torch.cumsum(prev * (1 - st_), dim=1) + trail.unsqueeze(1)
    return le, te


def latch_by_segments(mag, lead_th, trail_th, entry, seg):
    """(2M, T) float32 counts by the kernel's decomposition, with segments
    of ``seg`` frames (the last one ragged, padded with holds)."""
    t_len, m = mag.shape
    tr = ((mag >= lead_th).to(torch.int64) - (mag <= trail_th).to(torch.int64))
    n_seg = -(-t_len // seg)
    tr = torch.cat([tr, tr.new_zeros((n_seg * seg - t_len, m))])
    tr = tr.view(n_seg, seg, m)
    summ = summaries(tr)
    # the exclusive prefix of every segment, by the composition in turn
    zeros = torch.zeros(m, dtype=torch.int64)
    run = (zeros, zeros, zeros, zeros)
    prefixes = []
    for i in range(n_seg):
        prefixes.append(run)
        run = compose(run, tuple(x[i] for x in summ))
    prefix = tuple(torch.stack([p[j] for p in prefixes]) for j in range(4))
    e = (torch.zeros(m) if entry is None else entry) > 0.5
    state0 = e.to(torch.int64).expand(n_seg, m)
    state, lead, trail = apply(prefix, state0, torch.zeros_like(state0),
                               torch.zeros_like(state0))
    le, te = walk(tr, state, lead, trail)
    le = le.reshape(n_seg * seg, m)[:t_len]
    te = te.reshape(n_seg * seg, m)[:t_len]
    return torch.cat([le.T, te.T]).to(torch.float32)


def _case(name, m, t_len):
    """(mag (T, M), lead, trail, entry or None), from a numpy seed."""
    rng = np.random.default_rng(31 + m)
    mag = (0.05 * np.abs(rng.standard_normal((t_len, m)))).astype(np.float32)
    lead = np.full(m, 0.5, np.float32)
    trail = np.full(m, 0.2, np.float32)
    entry = None
    for c in range(m):
        for s in range(17 + 11 * c, t_len - 40, 97 + 13 * c):
            mag[s:s + 20 + 3 * c, c] = 0.8
    if name == "entry_mixed":
        entry = (np.arange(m) % 2).astype(np.float32)
        mag[:5, :] = 0.3   # hold: the entry state carries on
    if name == "holds_between":
        # set, then a long run of holds over whole segments, then a reset
        mag[:, 0] = 0.05
        mag[100:103, 0] = 0.9
        mag[103:700, 0] = 0.3
        mag[700, 0] = 0.1
    if name == "threshold_on_boundaries":
        trail = lead.copy()    # lead == trail: a sample on it holds
        for b in (7, 14, 512, 519):
            mag[b % t_len, :] = 0.5
            mag[(b - 1) % t_len, :] = 0.5
    if name == "open_at_end":
        mag[-30:, :] = 0.9
        entry = (np.arange(m) % 3 == 0).astype(np.float32)
    return (torch.from_numpy(mag), torch.from_numpy(lead),
            torch.from_numpy(trail),
            None if entry is None else torch.from_numpy(entry))


CASES = ["plain", "entry_mixed", "holds_between", "threshold_on_boundaries",
         "open_at_end"]
T_LEN = 1001   # a multiple of none of the segment lengths but T


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("seg", [1, 7, 512, T_LEN])
@pytest.mark.parametrize("name", CASES)
def test_decomposition_equals_the_plain_latch(name, seg, m):
    mag, lead, trail, entry = _case(name, m, T_LEN)
    want = latch_cumsums_plain(mag, lead, trail, entry)
    got = latch_by_segments(mag, lead, trail, entry, seg)
    assert torch.equal(got, want)
    assert want[:m, -1].min() >= 1   # pulses were found


def test_entry_active_with_no_transfer_at_all():
    m = 3
    mag = torch.full((600, m), 0.3)   # between the thresholds: all holds
    lead, trail = torch.full((m,), 0.5), torch.full((m,), 0.2)
    entry = torch.tensor([1.0, 0.0, 1.0])
    want = latch_cumsums_plain(mag, lead, trail, entry)
    for seg in (1, 7, 512):
        assert torch.equal(latch_by_segments(mag, lead, trail, entry, seg),
                           want)
    assert not want.any()   # no edge: the entered pulses stay open


_transfer = st.sampled_from([-1, 0, 1])


@st.composite
def summary(draw):
    f = draw(_transfer)
    if f == 0:
        return NONE
    return (f, draw(_transfer.filter(lambda v: v != 0)),
            draw(st.integers(0, 1000)), draw(st.integers(0, 1000)))


@settings(max_examples=200, deadline=None)
@given(summary(), summary(), summary())
def test_composition_is_associative(a, b, c):
    assert compose(compose(a, b), c) == compose(a, compose(b, c))
    assert compose(NONE, a) == a == compose(a, NONE)


@settings(max_examples=100, deadline=None)
@given(st.lists(_transfer, min_size=1, max_size=40), st.integers(0, 40))
def test_summary_of_a_concatenation_is_the_composition(seq, cut):
    cut = min(cut, len(seq))

    def one(s):
        if not s:
            return NONE
        t = torch.tensor(s, dtype=torch.int64).view(1, -1, 1)
        return tuple(int(x) for x in summaries(t))

    assert one(seq) == compose(one(seq[:cut]), one(seq[cut:]))


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's time-major latch at M = 8, T = 1000 (interpret)."""
    rng = np.random.default_rng(5)
    m, t_len = 8, 1000
    mag = (0.02 * np.abs(rng.standard_normal((t_len, m)))).astype(np.float32)
    for c in range(m):
        mag[60 + 40 * c:200 + 40 * c, c] += 0.6
        mag[900 + 5 * c:, c] += 0.6   # open at the end
    lead = np.full(m, 0.3, np.float32)
    trail = np.full(m, 0.1, np.float32)
    entry = (np.arange(m) % 2).astype(np.float32)
    cl, ct = pallas_latch_cumsums(jnp.asarray(mag), jnp.asarray(lead),
                                  jnp.asarray(trail), jnp.asarray(entry),
                                  t_blk=256, interpret=True)
    ref = np.concatenate([np.asarray(cl)[:m, :t_len],
                          np.asarray(ct)[:m, :t_len]])
    return mag, lead, trail, entry, ref


@pytest.mark.parametrize("seg", [7, 512])
def test_decomposition_equals_the_jax_kernel(jax_reference, seg):
    mag, lead, trail, entry, ref = jax_reference
    got = latch_by_segments(torch.from_numpy(mag), torch.from_numpy(lead),
                            torch.from_numpy(trail), torch.from_numpy(entry),
                            seg)
    np.testing.assert_array_equal(got.numpy(), ref)
