"""The decomposition that the channel-major latch kernel (K3,
``latch_scan_kernel`` in ``csrc/latch.cu``) runs on the card, modelled in
plain PyTorch and held bit for bit against the port's
``latch_cumsums_cm_plain`` and the JAX package's
``pallas_latch_cumsums_cm`` (interpret mode).

A block owns one segment of 4096 frames of one row.  It takes its (row,
segment) from a ticket, segment-major across rows; summarises its segment
as (f, l, L, R): f its first non-hold transfer, l its last (0 if none), L /
R the leading and trailing edges strictly after the position of f; publishes
that aggregate; walks back over its row's earlier segments, composing their
published words until it meets an inclusive prefix (a row's first segment
publishes one at once: it enters in the row's own entry state); and walks
its samples from the entry state and counts the prefix gives.  Here the
published words are replayed in ticket order, each predecessor found either
with its inclusive prefix or only with its aggregate, so that the walk
composes windows of aggregates as the kernel's does.  The model lives in
this file, not in the package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.latch_kernel import pallas_latch_cumsums_cm
from sdr_channelizer_tpu_torch.ops.cuda.latch_kernel import (
    latch_cumsums_cm_plain,
)

torch.set_num_threads(1)

SEG = 4096    # frames a block of the channel-major scan owns
WINDOW = 32   # predecessors a warp inspects at once
NONE = (0, 0, 0, 0)


def compose(a, b):
    """Summary of segment A followed by segment B."""
    f = a[0] if a[0] else b[0]
    l_ = b[1] if b[1] else a[1]
    return (f, l_, a[2] + b[2] + int(a[1] == -1 and b[0] == 1),
            a[3] + b[3] + int(a[1] == 1 and b[0] == -1))


def summary(tr):
    """(f, l, L, R) of one segment's transfers (1-D int64)."""
    nz = tr[tr != 0].tolist()
    if not nz:
        return NONE
    lead = sum(int(p == -1 and q == 1) for p, q in zip(nz, nz[1:]))
    trail = sum(int(p == 1 and q == -1) for p, q in zip(nz, nz[1:]))
    return nz[0], nz[-1], lead, trail


def walk(tr, state, lead, trail):
    """Inclusive counts over one segment, entered in ``state`` with the
    base counts ``lead`` / ``trail``."""
    out_l, out_t = [], []
    for t in tr.tolist():
        prev = state
        if t:
            state = int(t > 0)
        lead += state & (1 - prev)
        trail += prev & (1 - state)
        out_l.append(lead)
        out_t.append(trail)
    return out_l, out_t


def latch_by_tickets(mag, lead_th, trail_th, m_real, entry, seed=0,
                     p_incl=0.3):
    """(2R, T) float32 counts by the kernel's decomposition; a finished
    predecessor is seen with its inclusive prefix with probability
    ``p_incl`` (always at the row's first segment)."""
    r, t_len = mag.shape
    inf = torch.full((r - m_real,), float("inf"))
    lead_c = torch.cat([lead_th, inf])[:, None]
    trail_c = torch.cat([trail_th, inf])[:, None]
    tr = ((mag >= lead_c).to(torch.int64) - (mag <= trail_c).to(torch.int64))
    ent = torch.zeros(r) if entry is None else torch.cat(
        [entry, torch.zeros(r - m_real)])
    n_seg = -(-t_len // SEG)
    rng = np.random.default_rng(seed)
    aggregate, inclusive = {}, {}
    out = torch.zeros((2 * r, t_len), dtype=torch.float32)
    for ticket in range(n_seg * r):
        seg, row = divmod(ticket, r)          # segment-major
        t0 = seg * SEG
        part = tr[row, t0:t0 + SEG]
        total = summary(part)
        aggregate[row, seg] = total
        # look back: nearest predecessor first, a window at a time, until
        # an inclusive prefix; segment 0 has its own at once
        run = NONE
        j = seg - 1
        while j >= 0:
            window = []
            for _ in range(WINDOW):
                if j < 0:
                    break
                # a predecessor still running has published its aggregate
                # only; the one before the walk's start always has finished
                seen_incl = (row, j) in inclusive and (
                    j == 0 or rng.random() < p_incl)
                window.append(inclusive[row, j] if seen_incl
                              else aggregate[row, j])
                j -= 1
                if seen_incl:
                    j = -1
                    break
            for w in window:                  # earlier segments compose first
                run = compose(w, run)
        inclusive[row, seg] = compose(run, total)
        state = int(ent[row] > 0.5)
        lead = run[2] + int(state == 0 and run[0] == 1)
        trail = run[3] + int(state == 1 and run[0] == -1)
        if run[1]:
            state = int(run[1] > 0)
        le, te = walk(part, state, lead, trail)
        out[row, t0:t0 + len(le)] = torch.tensor(le, dtype=torch.float32)
        out[r + row, t0:t0 + len(te)] = torch.tensor(te, dtype=torch.float32)
    return out


def _case(r, m_real, t_len, seed=11):
    """(mag_cm (R, T), lead, trail, entry) with every case the kernel must
    meet: pulses across segment boundaries, entry states mixed, samples
    exactly on lead and on trail, a pulse open at T - 1, a row with no
    transfer at all."""
    rng = np.random.default_rng(seed + r + t_len)
    mag = (0.05 * np.abs(rng.standard_normal((r, t_len)))).astype(np.float32)
    for c in range(m_real):
        for s in range(17 + 131 * c, t_len - 40, 577 + 97 * c):
            mag[c, s:s + 60 + 11 * c] = 0.8
        mag[c, SEG - 30: SEG + 30] = 0.9 if c % 2 else 0.05  # over a boundary
    lead = np.full(m_real, 0.5, np.float32)
    trail = np.full(m_real, 0.2, np.float32)
    mag[0, 5] = 0.5                  # exactly on lead
    mag[0, 9] = 0.2                  # exactly on trail
    mag[1, :] = 0.35                 # holds only: no transfer at all
    mag[2, -25:] = 0.9               # open at T - 1
    entry = (np.arange(m_real) % 2).astype(np.float32)
    if m_real > 3:
        trail[3] = lead[3]           # lead == trail: a sample on it holds
        mag[3, 100:110] = 0.5
    return (torch.from_numpy(mag), torch.from_numpy(lead),
            torch.from_numpy(trail), torch.from_numpy(entry))


SHAPES = [(8, 6, SEG - 1), (8, 6, SEG), (8, 6, SEG + 1), (16, 13, 3 * SEG + 1)]


@pytest.mark.parametrize("entered", [False, True])
@pytest.mark.parametrize("r,m_real,t_len", SHAPES)
def test_decomposition_equals_the_plain_latch(r, m_real, t_len, entered):
    mag, lead, trail, entry = _case(r, m_real, t_len)
    entry = entry if entered else None
    want = latch_cumsums_cm_plain(mag, lead, trail, m_real, entry)
    got = latch_by_tickets(mag, lead, trail, m_real, entry, seed=t_len)
    assert torch.equal(got, want)
    assert want[:m_real, -1].sum() > 4       # pulses were found
    assert not want[m_real:r].any()          # pad rows never open
    assert not want[[1, r + 1]].any()        # the row with no transfer


def test_open_pulse_gets_no_trailing_edge():
    mag, lead, trail, entry = _case(8, 6, SEG + 1)
    got = latch_by_tickets(mag, lead, trail, 6, entry)
    assert got[2, -1] + entry[2] - got[8 + 2, -1] == 1


@pytest.mark.parametrize("p_incl", [0.0, 0.05, 1.0])
def test_walk_back_does_not_depend_on_what_is_published(p_incl):
    """Long rows: the look-back meets aggregates over up to three windows
    before an inclusive prefix (none seen but the row's first), a few, or
    the nearest predecessor's; the counts do not change."""
    mag, lead, trail, entry = _case(4, 4, 70 * SEG + 3)
    want = latch_cumsums_cm_plain(mag, lead, trail, 4, entry)
    assert torch.equal(latch_by_tickets(mag, lead, trail, 4, entry,
                                        seed=7, p_incl=p_incl), want)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's channel-major latch (interpret mode) on two of the
    shapes, with zero pad columns up to its time block; the pad closes an
    open pulse only past T."""
    out = {}
    for r, m_real, t_len in (SHAPES[2], SHAPES[3]):
        mag, lead, trail, entry = _case(r, m_real, t_len)
        t_pad = -(-t_len // 2048) * 2048
        padded = np.zeros((r, t_pad), np.float32)
        padded[:, :t_len] = mag.numpy()
        ref = np.asarray(pallas_latch_cumsums_cm(
            jnp.asarray(padded), jnp.asarray(lead.numpy()),
            jnp.asarray(trail.numpy()), m_real,
            entry_active=jnp.asarray(entry.numpy()), interpret=True))
        out[t_len] = ref[:, :t_len]
    return out


@pytest.mark.parametrize("r,m_real,t_len", [SHAPES[2], SHAPES[3]])
def test_decomposition_equals_the_jax_kernel(jax_reference, r, m_real, t_len):
    mag, lead, trail, entry = _case(r, m_real, t_len)
    got = latch_by_tickets(mag, lead, trail, m_real, entry)
    np.testing.assert_array_equal(got.numpy(), jax_reference[t_len])
