"""The port's event prediction against the JAX package: the host fits and
the predictor exactly (the same float64 NumPy code), the on-device masked
quadratic fit at rtol 1e-5 against ``jnp`` (float32 sums in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import EventConfig as JEventConfig
from sdr_channelizer_tpu.dsp import events as jev
from sdr_channelizer_tpu_torch.config import EventConfig
from sdr_channelizer_tpu_torch.dsp import events as tev

torch.set_num_threads(1)


def _parabola(seed, n=40, peak=0.031, span=0.08):
    rng = np.random.default_rng(seed)
    toa = np.sort(rng.uniform(0.0, span, n))
    snr = 30.0 - 2000.0 * (toa - peak) ** 2 + rng.normal(0, 0.3, n)
    return toa, snr


def test_config_is_the_jax_config():
    assert EventConfig() == EventConfig(**vars(JEventConfig()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quadratic_peak_time_exact(seed):
    toa, snr = _parabola(seed)
    toa = toa + 1723800000.0 * (seed % 2)   # epoch TOAs, centred inside
    assert tev.quadratic_peak_time(toa, snr) == jev.quadratic_peak_time(toa, snr)


def test_quadratic_peak_time_rejects_and_degenerates():
    with pytest.raises(ValueError):
        tev.quadratic_peak_time([0.0, 1.0], [1.0, 2.0])
    line = np.arange(5.0)
    assert np.isnan(tev.quadratic_peak_time(line, 2 * line)) == \
        np.isnan(jev.quadratic_peak_time(line, 2 * line))


@pytest.mark.parametrize("events", [[3.0], [0.1, 0.6], [0.1, 0.6, 1.12, 1.6]])
def test_next_event_time_exact(events):
    assert tev.next_event_time(events) == jev.next_event_time(events)
    with pytest.raises(ValueError):
        tev.next_event_time([])


def test_event_predictor_exact():
    tp, jp = tev.EventPredictor(), jev.EventPredictor()
    for seed in range(6):
        toa, snr = _parabola(seed, peak=0.03 + 0.5 * seed, span=0.08)
        toa = toa + 0.5 * seed
        gate = 0.5 if seed == 2 else 1.0          # one capture gated out
        few = 2 if seed == 4 else len(toa)        # one with too few pulses
        assert tp.update(toa[:few], snr[:few], max_abs_iq=gate) == \
            jp.update(toa[:few], snr[:few], max_abs_iq=gate)
    assert tp.events == jp.events and tp.fits == jp.fits
    assert len(tp.events) == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_masked_fit_matches_jnp(seed):
    rng = np.random.default_rng(seed)
    toa, snr = _parabola(seed, n=64)
    toa = toa.astype(np.float32)
    snr = snr.astype(np.float32)
    valid = rng.random(64) < 0.7
    got = tev.quadratic_peak_time_masked(torch.from_numpy(toa),
                                         torch.from_numpy(snr),
                                         torch.from_numpy(valid))
    ref = jev.quadratic_peak_time_masked(jnp.asarray(toa), jnp.asarray(snr),
                                         jnp.asarray(valid))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    # and the host float64 fit over the valid points agrees to float32's
    # conditioning
    np.testing.assert_allclose(float(got),
                               jev.quadratic_peak_time(toa[valid], snr[valid]),
                               rtol=1e-3)


@pytest.mark.parametrize("n_valid", [0, 2])
def test_masked_fit_is_nan_below_three_points(n_valid):
    toa, snr = (torch.from_numpy(x.astype(np.float32)) for x in _parabola(0))
    valid = torch.arange(len(toa)) < n_valid
    assert torch.isnan(tev.quadratic_peak_time_masked(toa, snr, valid))
    assert np.isnan(float(jev.quadratic_peak_time_masked(
        jnp.asarray(toa.numpy()), jnp.asarray(snr.numpy()),
        jnp.asarray(valid.numpy()))))
