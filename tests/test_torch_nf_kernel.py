"""The port's noise floor (kernel K2's plain version) against the JAX
package's Pallas kernel on the same magnitude array: equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.nf_kernel import pallas_noise_floor_cm
from sdr_channelizer_tpu_torch.ops.cuda import nf_kernel

torch.set_num_threads(1)

T_PAD = 1024


def _mag(kind):
    rng = np.random.default_rng(5)
    mag = np.abs(rng.standard_normal((8, T_PAD))).astype(np.float32)
    if kind == "duplicates":
        mag = np.round(mag * 4) / 4  # a few distinct values: ties at the median
    elif kind == "constant":
        mag[:] = 0.25
    return mag


@pytest.fixture(scope="module")
def medians():
    """One interpret-mode run of the JAX kernel per case."""
    out = {}
    for kind in ("random", "duplicates", "constant"):
        for t_len in (1000, 1001, T_PAD):
            mag = _mag(kind)
            mag[:, t_len:] = 0.0  # pad columns, as the channelizer leaves them
            ref = pallas_noise_floor_cm(jnp.asarray(mag), t_len=t_len,
                                        interpret=True)
            out[kind, t_len] = (mag, np.asarray(ref))
    return out


@pytest.mark.parametrize("t_len", [1000, 1001, T_PAD])
@pytest.mark.parametrize("kind", ["random", "duplicates", "constant"])
def test_noise_floor_matches_jax_kernel(medians, kind, t_len):
    mag, ref = medians[kind, t_len]
    got = nf_kernel.noise_floor_cm(torch.from_numpy(mag), t_len).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.median(mag[:, :t_len], axis=1))


def test_pad_columns_are_not_read():
    mag = _mag("random")
    a = nf_kernel.noise_floor_cm(torch.from_numpy(mag), 777)
    mag[:, 777:] = 1e9
    b = nf_kernel.noise_floor_cm(torch.from_numpy(mag), 777)
    assert torch.equal(a, b)


def test_empty_and_bad_arguments():
    mag = torch.from_numpy(_mag("random"))
    assert torch.isnan(nf_kernel.noise_floor_cm(mag, 0)).all()
    with pytest.raises(ValueError):
        nf_kernel.noise_floor_cm(mag, T_PAD + 1)
    with pytest.raises(TypeError):
        nf_kernel.noise_floor_cm(mag.double(), 10)
