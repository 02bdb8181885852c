"""The port's latch (kernel K3's plain version) against the JAX package's
Pallas kernel on the same magnitudes and thresholds: equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.latch_kernel import pallas_latch_cumsums_cm
from sdr_channelizer_tpu_torch.ops.cuda import latch_kernel

torch.set_num_threads(1)

R, M_REAL, T = 8, 6, 1024


def _case(name):
    """(mag_cm, lead, trail, entry_active or None, t_len)."""
    rng = np.random.default_rng(11)
    mag = (0.01 * np.abs(rng.standard_normal((R, T)))).astype(np.float32)
    mag[M_REAL:] = 0.0  # pad rows
    for r in range(M_REAL):
        for s in range(40 + 13 * r, T - 200, 150 + 7 * r):
            mag[r, s:s + 30 + 5 * r] += 0.5
    lead = np.full(M_REAL, 0.2, np.float32)
    trail = np.full(M_REAL, 0.05, np.float32)
    entry, t_len = None, T
    if name == "entry_active":
        entry = np.array([1, 0, 1, 0, 0, 1], np.float32)
        mag[0, :25] += 0.5   # entered active and still high
    elif name == "threshold_held":
        # lead == trail and samples exactly on it: hold, not toggle
        trail = lead.copy()
        mag[:M_REAL, 300:306] = 0.2
        mag[:M_REAL, 60:63] = 0.2
    elif name == "open_at_end":
        t_len = 1000
        mag[:M_REAL, 980:] += 0.5
        mag[:, t_len:] = 0.0  # the pad columns the JAX kernel is handed
    return mag, lead, trail, entry, t_len


CASES = ["plain", "entry_active", "threshold_held", "open_at_end"]


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name in CASES:
        mag, lead, trail, entry, _ = _case(name)
        out[name] = np.asarray(pallas_latch_cumsums_cm(
            jnp.asarray(mag), jnp.asarray(lead), jnp.asarray(trail), M_REAL,
            entry_active=None if entry is None else jnp.asarray(entry),
            interpret=True))
    return out


@pytest.mark.parametrize("name", CASES)
def test_latch_matches_jax_kernel(reference, name):
    mag, lead, trail, entry, t_len = _case(name)
    got = latch_kernel.latch_cumsums_cm(
        torch.from_numpy(mag[:, :t_len].copy()), torch.from_numpy(lead),
        torch.from_numpy(trail), M_REAL,
        None if entry is None else torch.from_numpy(entry)).numpy()
    assert got.shape == (2 * R, t_len)
    np.testing.assert_array_equal(got, reference[name][:, :t_len])
    assert got[:M_REAL, -1].min() >= 4          # pulses were found
    assert not got[M_REAL:R].any() and not got[R + M_REAL:].any()  # pad rows


def test_threshold_sample_holds_where_the_oracle_toggles():
    """The three-state rule of the kernel against the two-bit oracle scan."""
    from sdr_channelizer_tpu_torch.dsp.pdw import hysteresis_scan

    mag = torch.tensor([[0.0, 1.0, 0.5, 0.5, 0.0, 0.5, 0.0]])
    th = torch.tensor([0.5])
    got = latch_kernel.latch_cumsums_cm(mag, th, th)
    # opens at 1, holds through the two samples on the threshold, closes at
    # 4; the sample on the threshold at 5 holds the closed state
    np.testing.assert_array_equal(got[0].numpy(), [0, 1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(got[1].numpy(), [0, 0, 0, 0, 1, 1, 1])
    oracle = hysteresis_scan(mag >= 0.5, mag <= 0.5)[0].numpy()
    np.testing.assert_array_equal(oracle, [0, 1, 0, 1, 0, 1, 0])


def test_pulse_open_at_the_end_gets_no_trailing_edge():
    mag = torch.zeros((1, 50))
    mag[0, 10:20] = 1.0
    mag[0, 40:] = 1.0
    got = latch_kernel.latch_cumsums_cm(mag, torch.tensor([0.5]),
                                        torch.tensor([0.25]))
    assert got[0, -1] == 2 and got[1, -1] == 1


def test_bad_arguments():
    mag = torch.zeros((4, 16))
    with pytest.raises(ValueError):
        latch_kernel.latch_cumsums_cm(mag, torch.zeros(3), torch.zeros(4))
    with pytest.raises(TypeError):
        latch_kernel.latch_cumsums_cm(mag.double(), torch.zeros(4),
                                      torch.zeros(4))
