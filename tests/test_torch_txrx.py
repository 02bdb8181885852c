"""The port's TX/RX loopback against the JAX package's: the waveforms and
the channel bit for bit, ``run_txrx``'s ``.iq`` files byte for byte, and
the same matched-filter delay."""

import dataclasses
import os

import numpy as np
import pytest

from sdr_channelizer_tpu.capture import txrx as jtxrx
from sdr_channelizer_tpu_torch.capture import txrx as ttxrx
from sdr_channelizer_tpu_torch.io import iqpacket as tiq

SPECS = {
    "flat": dict(),
    "barker13": dict(barker13=True, chip_width_sec=5e-6, delay_samples=37),
    "fast": dict(sample_rate_sps=20e6, pri_sec=0.5e-3, duration_sec=2e-3,
                 attenuation_db=6.0, noise_std=1e-2),
}


def _specs(name):
    kw = SPECS[name]
    return ttxrx.TxRxSpec(**kw), jtxrx.TxRxSpec(**kw)


def test_spec_is_the_jax_spec():
    t, j = _specs("flat")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.chip_samples, t.pulse_samples) == (j.chip_samples,
                                                j.pulse_samples) == (80, 1040)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_waveform_and_channel_are_the_jax_ones(name):
    t, j = _specs(name)
    tx, jtx = ttxrx.tx_waveform(t), jtxrx.tx_waveform(j)
    assert tx.dtype == np.complex64 and tx.tobytes() == jtx.tobytes()
    rx, jrx = ttxrx.loopback(tx, t, seed=3), jtxrx.loopback(jtx, j, seed=3)
    assert rx.tobytes() == jrx.tobytes()


@pytest.mark.parametrize("bit_width", [12, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_txrx_writes_the_jax_files(tmp_path, name, bit_width):
    t, j = _specs(name)
    got = ttxrx.run_txrx(t, str(tmp_path / "t"), start_epoch=1723800000.25,
                         bit_width=bit_width, seed=1)
    ref = jtxrx.run_txrx(j, str(tmp_path / "j"), start_epoch=1723800000.25,
                         bit_width=bit_width, seed=1)
    for g, r in zip(got, ref):
        assert os.path.basename(g) == os.path.basename(r)
        assert open(g, "rb").read() == open(r, "rb").read()
    # the loop closes: the recorded RX correlates at the channel delay,
    # which a periodic pulse train names modulo its PRI
    tx, rx = (tiq.to_complex(np.asarray(tiq.read_iq(p)[1]), bit_width)
              for p in got)
    pri = int(round(t.pri_sec * t.sample_rate_sps))
    delay = ttxrx.matched_filter_delay(tx, rx, max_lag=pri)
    assert delay == jtxrx.matched_filter_delay(tx, rx, max_lag=pri) \
        == t.delay_samples


def test_barker13_needs_13_chips():
    spec = ttxrx.TxRxSpec(barker13=True, num_chips=7)
    with pytest.raises(ValueError, match="13 chips"):
        ttxrx.tx_waveform(spec)


def test_matched_filter_delay_with_a_lag_bound():
    t, _ = _specs("fast")
    tx = ttxrx.tx_waveform(t)
    rx = ttxrx.loopback(tx, t, seed=0)
    for max_lag in (50, 101, None):
        assert ttxrx.matched_filter_delay(tx, rx, max_lag) == \
            jtxrx.matched_filter_delay(tx, rx, max_lag)
