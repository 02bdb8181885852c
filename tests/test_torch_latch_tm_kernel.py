"""The port's time-major latch (the plain version of ``latch_cumsums``)
against the JAX package's ``pallas_latch_cumsums`` on the same magnitudes
and thresholds: equal bit for bit on the real rows and columns."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.latch_kernel import pallas_latch_cumsums
from sdr_channelizer_tpu_torch.ops.cuda import latch_kernel
from sdr_channelizer_tpu_torch.ops.rank_find import find_ranks_cm

torch.set_num_threads(1)

T = 1000  # no multiple of the JAX kernel's time block


def _case(name):
    """(mag (T, M), lead, trail, entry_active or None)."""
    m = 12 if name == "ragged_m" else 8
    rng = np.random.default_rng(23)
    mag = (0.01 * np.abs(rng.standard_normal((T, m)))).astype(np.float32)
    for c in range(m):
        for s in range(40 + 13 * c, T - 200, 150 + 7 * c):
            mag[s:s + 30 + 5 * c, c] += 0.5
    lead = np.full(m, 0.2, np.float32)
    trail = np.full(m, 0.05, np.float32)
    entry = None
    if name in ("entry_active", "open_at_end_entry"):
        entry = (np.arange(m) % 3 == 0).astype(np.float32)
        mag[:25, 0] += 0.5   # entered active and still high
    if name == "threshold_held":
        # lead == trail and samples exactly on it: hold, not toggle
        trail = lead.copy()
        mag[300:306] = 0.2
        mag[60:63] = 0.2
    if name.startswith("open_at_end"):
        mag[980:] += 0.5
    return mag, lead, trail, entry


CASES = ["plain", "ragged_m", "entry_active", "threshold_held", "open_at_end",
         "open_at_end_entry"]


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name in CASES:
        mag, lead, trail, entry = _case(name)
        out[name] = [np.asarray(x) for x in pallas_latch_cumsums(
            jnp.asarray(mag), jnp.asarray(lead), jnp.asarray(trail),
            None if entry is None else jnp.asarray(entry), t_blk=256,
            interpret=True)]
    return out


def _port(name):
    mag, lead, trail, entry = _case(name)
    return latch_kernel.latch_cumsums(
        torch.from_numpy(mag), torch.from_numpy(lead), torch.from_numpy(trail),
        None if entry is None else torch.from_numpy(entry))


@pytest.mark.parametrize("name", CASES)
def test_latch_tm_matches_jax_kernel(reference, name):
    m = _case(name)[0].shape[1]
    got = _port(name).numpy()
    cl, ct = reference[name]
    assert got.shape == (2 * m, T) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:m], cl[:m, :T])
    np.testing.assert_array_equal(got[m:], ct[:m, :T])
    assert got[:m, -1].min() >= 3          # pulses were found


@pytest.mark.parametrize("name", CASES)
def test_latch_tm_equals_the_channel_major_latch_on_the_flip(name):
    mag, lead, trail, entry = _case(name)
    ent = None if entry is None else torch.from_numpy(entry)
    flipped = latch_kernel.latch_cumsums_cm(
        torch.from_numpy(np.ascontiguousarray(mag.T)), torch.from_numpy(lead),
        torch.from_numpy(trail), None, ent)
    assert torch.equal(_port(name), flipped)


@pytest.mark.parametrize("name", ["open_at_end", "open_at_end_entry"])
def test_open_pulse_is_answered_with_the_sentinel(reference, name):
    """The JAX kernel pads the time axis with -inf, so a pulse open at T
    closes at column T; the port has no pad columns.  The rank search gives
    T for that trailing edge either way."""
    mag, _, _, entry = _case(name)
    m = mag.shape[1]
    got = _port(name)
    skip = np.zeros(m, np.float32) if entry is None else entry
    opens = got[:m, -1].numpy() + skip - got[m:, -1].numpy()
    np.testing.assert_array_equal(opens, np.ones(m))   # every channel open
    ct_jax = reference[name][1]
    assert (ct_jax[:m, T] == got[m:, -1].numpy() + 1).all()  # closed in the pad
    # the trailing edge of the open pulse: rank = its count + 1
    rank = torch.from_numpy(got[m:, -1].numpy() + 1)[:, None]
    ours = find_ranks_cm(got[m:], rank, T).numpy()
    theirs = find_ranks_cm(torch.from_numpy(ct_jax[:m].copy()), rank, T).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert (ours == T).all()


def test_bad_arguments():
    mag = torch.zeros((16, 4))
    with pytest.raises(ValueError):
        latch_kernel.latch_cumsums(mag, torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError):
        latch_kernel.latch_cumsums(mag, torch.zeros(4), torch.zeros(4),
                                   torch.zeros(5))
    with pytest.raises(TypeError):
        latch_kernel.latch_cumsums(mag.double(), torch.zeros(4),
                                   torch.zeros(4))
