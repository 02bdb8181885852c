"""The port's event-mode extraction (``extract_pdws_event[_planes]``, the
tracker's mean-amplitude core) against the JAX package on the capture of
``tests/test_pdw_event.py``: the indices, counts, validity and saturation
exactly, ``mag`` at rtol 2e-5 (float32 prefix sums in another order),
``snr_db`` at 2e-4 dB; and against that file's sequential oracle of the
C++ loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from test_pdw_event import cpp_tracker_oracle, make_capture

torch.set_num_threads(1)

EXACT = ("toa_idx", "te_idx", "pw_sec", "count", "valid", "saturated",
         "freq_offset_hz")


def _capture(seed):
    iq = make_capture(seed=seed)
    iq[40_100:40_110] = 1.0    # a saturated stretch inside the 512 pulse
    return iq


def _assert_batches(got, ref):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=2e-5)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_event_extraction_matches_jax(seed):
    iq = _capture(seed)
    cfg = PdwConfig.event(max_pulses=64)
    got = tpdw.extract_pdws_event(torch.from_numpy(iq), cfg)
    ref = jpdw.extract_pdws_event(jnp.asarray(iq), JPdwConfig.event(max_pulses=64))
    _assert_batches(got, ref)
    count = int(got.count)
    assert count >= 6 and bool(got.saturated.any())
    # the pulse open at capture end was not emitted
    assert int(got.toa_idx[:count].max()) < len(iq) - 200
    # and the C++ loop's own sequential answer
    _, want = cpp_tracker_oracle(iq, snr_db=cfg.snr_threshold_db)
    assert count == len(want)
    np.testing.assert_array_equal(got.toa_idx.numpy()[:count],
                                  [w[0] for w in want])
    np.testing.assert_allclose(got.mag.numpy()[:count], [w[2] for w in want],
                               rtol=2e-5)
    np.testing.assert_array_equal(got.saturated.numpy()[:count],
                                  [w[4] for w in want])


def test_event_planes_match_jax_planes():
    iq = _capture(0)
    xr = np.ascontiguousarray(iq.real)
    xi = np.ascontiguousarray(iq.imag)
    got = tpdw.extract_pdws_event_planes(torch.from_numpy(xr),
                                         torch.from_numpy(xi),
                                         PdwConfig.event(max_pulses=64))
    ref = jpdw.extract_pdws_event_planes(jnp.asarray(xr), jnp.asarray(xi),
                                         JPdwConfig.event(max_pulses=64))
    _assert_batches(got, ref)


@pytest.mark.parametrize("block", [512, 64, 4096])
def test_event_core_given_floor_any_block(block):
    """The core on given streams and floor at other block sizes: the two
    levels of the prefix sums change no index."""
    iq = _capture(1)
    mag = np.abs(iq).astype(np.float32)
    sat = (np.abs(iq.real) >= 0.9999) | (np.abs(iq.imag) >= 0.9999)
    nf = np.float32(mag.mean())
    got = tpdw._extract_event_core(torch.from_numpy(mag), torch.from_numpy(sat),
                                   torch.tensor(nf), 20.0, 16, block=block)
    ref = jpdw._extract_event_core(jnp.asarray(mag), jnp.asarray(sat),
                                   jnp.asarray(nf), snr_threshold_db=20.0,
                                   max_pulses=16, block=block)
    _assert_batches(got, ref)


def test_more_pulses_than_slots_and_none():
    iq = _capture(0)
    got = tpdw.extract_pdws_event(torch.from_numpy(iq),
                                  PdwConfig.event(max_pulses=3))
    assert int(got.count) == 3 and bool(got.valid.all())
    quiet = np.full(5000, 1e-3 + 0j, np.complex64)
    none = tpdw.extract_pdws_event(torch.from_numpy(quiet),
                                   PdwConfig.event(max_pulses=8))
    assert int(none.count) == 0 and not bool(none.valid.any())
    assert bool((none.toa_idx == -1).all())
