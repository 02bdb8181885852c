"""The port's flip (the plain version of the flip kernel) against the JAX
package's ``pallas_cm_streams`` in interpret mode on the same inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.transpose_kernel import pallas_cm_streams
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel as tk

torch.set_num_threads(1)

SHAPES = [(1000, 8), (1, 1), (2, 3), (2500, 1)]


def _streams(t_len, m, seed=0):
    """Time-major magnitude, phase in degrees with steps on both sides of
    the wrap and exactly on it, and a 0/1 mask."""
    rng = np.random.default_rng(seed + 1000 * m + t_len)
    mag = rng.random((t_len, m), dtype=np.float32)
    ph = ((rng.random((t_len, m), dtype=np.float32) - 0.5) * 360.0
          ).astype(np.float32)
    if t_len > 6:
        ph[3], ph[4], ph[5] = 180.0, -180.0, 180.0   # steps of exactly +-360
        ph[6] = 0.0                                   # a step of exactly -180
    sat = (rng.random((t_len, m)) > 0.8).astype(np.float32)
    return mag, ph, sat


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"T{t}-M{m}" for t, m in SHAPES])
def flipped(request):
    """(JAX streams cut to the real rows and columns, the port's)."""
    t_len, m = request.param
    mag, ph, sat = _streams(t_len, m)
    ref = pallas_cm_streams(jnp.asarray(mag), jnp.asarray(ph),
                            jnp.asarray(sat), interpret=True)
    ref = [np.asarray(r) for r in ref]
    for r in ref:    # what the crop drops is the JAX kernel's zero pad
        assert not r[m:].any() and not r[:, t_len:].any()
    got = tk.cm_streams(*(torch.from_numpy(a) for a in (mag, ph, sat)))
    return ([r[:m, :t_len] for r in ref], [g.numpy() for g in got],
            (mag, ph, sat))


@pytest.mark.parametrize("stream", [0, 1, 2], ids=["mag", "dph", "sat"])
def test_cm_streams_match_jax_kernel_exactly(flipped, stream):
    ref, got, (mag, _, _) = flipped
    t_len, m = mag.shape
    assert got[stream].shape == (m, t_len)
    assert got[stream].dtype == np.float32
    np.testing.assert_array_equal(got[stream], ref[stream])


def test_flips_are_the_transposes_and_last_dph_column_is_zero(flipped):
    _, got, (mag, ph, sat) = flipped
    np.testing.assert_array_equal(got[0], mag.T)
    np.testing.assert_array_equal(got[2], sat.T)
    assert not got[1][:, -1].any()
    assert np.abs(got[1]).max(initial=0.0) <= 180.0


def test_wrap_is_strict_on_both_sides():
    ph = torch.tensor([[0.0], [180.0], [0.0], [-170.0], [170.0], [-170.0],
                       [10.0]])
    _, dph, _ = tk.cm_streams(torch.ones_like(ph), ph, torch.zeros_like(ph))
    # +180 and -180 stay; -340 -> 20, 340 -> -20; 180 -> 180; last is zero
    np.testing.assert_array_equal(
        dph.numpy(), [[180.0, -180.0, -170.0, -20.0, 20.0, 180.0, 0.0]])


def test_bool_mask_gives_the_float_masks_streams():
    mag, ph, sat = (torch.from_numpy(a) for a in _streams(300, 5))
    a = tk.cm_streams(mag, ph, sat)
    b = tk.cm_streams(mag, ph, sat > 0.5)
    assert b[2].dtype == torch.float32
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_an_infinite_magnitude_is_carried_not_spread():
    mag, ph, sat = (torch.from_numpy(a) for a in _streams(64, 2))
    mag[40, 1] = float("inf")
    mag_cm, dph_cm, _ = tk.cm_streams(mag, ph, sat)
    assert torch.isinf(mag_cm[1, 40]) and int(torch.isinf(mag_cm).sum()) == 1
    assert bool(torch.isfinite(dph_cm).all())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mag, ph, sat = (torch.from_numpy(a) for a in _streams(16, 4))
    with pytest.raises(TypeError):
        tk.cm_streams(mag.double(), ph, sat)
    with pytest.raises(TypeError):
        tk.cm_streams(mag, ph, sat.to(torch.int32))
    with pytest.raises(ValueError):
        tk.cm_streams(mag, ph[:8], sat)


def test_stage_tables_hold_the_flip():
    assert kernels.KERNELS.cm_streams is tk.cm_streams
    assert kernels.PLAIN.cm_streams is tk.cm_streams_plain
    assert tk.launches == 0   # nothing here runs on a card
