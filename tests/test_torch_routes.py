"""The single-shot routes of the port's fused steps (plain kernel versions
on the CPU): ``"flat"`` and ``"cm"`` against ``"cm2"`` and against the JAX
package's flat route, the planes ingest against the packed one, and the
complex-free step against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import (
    ChannelizerPipeline as JPipeline,
)
from sdr_channelizer_tpu_torch.dsp import channelizer as tchan
from sdr_channelizer_tpu_torch.models.pipeline import (
    ROUTES,
    ChannelizerPipeline,
)
from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
from torch_port_fixtures import M, PDW_FIELDS, packed, pulse_capture

torch.set_num_threads(1)

FS = 8e6
CFG = JPdwConfig.channelized(max_pulses=64, max_pulse_samples=256)
EXACT = ("toa_idx", "te_idx", "pw_sec", "saturated", "valid", "count")


def _pipelines():
    jpipe = JPipeline.create(M, pdw_cfg=CFG)
    tpipe = ChannelizerPipeline.from_reference(
        np.asarray(jpipe.channelizer.taps_rev), dataclasses.asdict(CFG),
        device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def routed():
    """The clipped capture through the port's three routes, and through the
    JAX package's flat route as it runs on the CPU: its flat channelizer
    kernel in interpret mode, then its oracle tail."""
    samples = pulse_capture(12)
    xq = packed(samples)
    jpipe, tpipe = _pipelines()
    ref = jpipe.forward_packed(jnp.asarray(xq), bit_width=12, route="flat")
    got = {r: tpipe.forward_packed(xq, 12, route=r)
           for r in ("cm2", "flat", "cm")}
    return samples, xq, ref, got


def test_route_names():
    assert ROUTES == ("auto", "cm2", "cm", "flat")
    _, tpipe = _pipelines()
    xq = packed(pulse_capture(12))
    a = tpipe.forward_packed(xq, 12)
    b = tpipe.forward_packed(xq, 12, route="cm2")
    assert torch.equal(a[1], b[1]) and torch.equal(a[2].toa_idx, b[2].toa_idx)


@pytest.mark.parametrize("route", ["flat", "cm"])
@pytest.mark.parametrize("field", PDW_FIELDS)
def test_route_matches_cm2_within_the_port(routed, route, field):
    """One channelizer body and exact medians: the batch of the cm2 route
    (``snr_db`` and the frequency up to the floor's and the median's last
    place)."""
    _, _, _, got = routed
    a, b = getattr(got[route][2], field), getattr(got["cm2"][2], field)
    assert int(got[route][2].count.sum()) > 8 and a.shape == b.shape
    if field in ("snr_db", "freq_offset_hz", "mag"):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, equal_nan=True)
    else:
        assert torch.equal(a, b), field


@pytest.mark.parametrize("route", ["flat", "cm"])
def test_route_returns_the_time_major_magnitude_and_its_median(routed, route):
    _, xq, _, got = routed
    nf, mag, _ = got[route]
    nf2, mag_cm, _ = got["cm2"]
    assert mag.shape == (len(xq) // M, M)
    assert torch.equal(mag, mag_cm.T)
    torch.testing.assert_close(nf, nf2, rtol=0, atol=0)


@pytest.mark.parametrize("field", EXACT)
def test_flat_route_matches_jax_flat_route_exact_keys(routed, field):
    _, _, (_, _, ref), got = routed
    np.testing.assert_array_equal(getattr(got["flat"][2], field).numpy(),
                                  np.asarray(getattr(ref, field)), err_msg=field)


def test_flat_route_matches_jax_flat_route_floats(routed):
    _, _, (nf_r, mag_r, ref), got = routed
    nf, mag, batch = got["flat"]
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5)
    np.testing.assert_allclose(batch.mag.numpy(), np.asarray(ref.mag),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(batch.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-3)
    f_got, f_ref = batch.freq_offset_hz.numpy(), np.asarray(ref.freq_offset_hz)
    np.testing.assert_array_equal(np.isnan(f_got), np.isnan(f_ref))
    ok = ~np.isnan(f_ref)
    np.testing.assert_allclose(f_got[ok], f_ref[ok], rtol=0,
                               atol=50.0 / (FS / M))
    assert bool(batch.saturated.any())


@pytest.mark.parametrize("route", ["cm2", "cm", "flat"])
@pytest.mark.parametrize("planes", ["float32", "int16"])
def test_forward_fused_matches_forward_packed(routed, route, planes):
    """The planes ingest, raw or dequantized, gives the packed ingest's
    batch bit for bit on every route."""
    samples, _, _, got = routed
    _, tpipe = _pipelines()
    xr = np.ascontiguousarray(samples[:, 0])
    xi = np.ascontiguousarray(samples[:, 1])
    if planes == "float32":
        xr, xi = (v.astype(np.float32) / 2048.0 for v in (xr, xi))
        out = tpipe.forward_fused(xr, xi, 0, route=route)
    else:
        out = tpipe.forward_fused(xr, xi, 12, route=route)
    assert torch.equal(out[0], got[route][0])
    assert torch.equal(out[1], got[route][1])
    for field in PDW_FIELDS:
        a, b = getattr(out[2], field), getattr(got[route][2], field)
        assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0)), field


def test_steps_are_the_forwards(routed):
    samples, xq, _, got = routed
    _, tpipe = _pipelines()
    xr = samples[:, 0].astype(np.float32) / 2048.0
    xi = samples[:, 1].astype(np.float32) / 2048.0
    assert torch.equal(tpipe.step_fused(xr, xi)[2].toa_idx,
                       got["cm2"][2].toa_idx)
    iq = iqpacket.to_complex(samples, 12)
    assert torch.equal(tpipe.step(iq)[2].toa_idx, tpipe.forward(iq)[2].toa_idx)
    assert torch.equal(tpipe.step_planes(xr, xi)[3].toa_idx,
                       tpipe.forward_planes(xr, xi)[3].toa_idx)


def test_forward_planes_matches_jax_forward_planes():
    samples = pulse_capture(12)
    iq = iqpacket.to_complex(samples, 12)
    xr = np.ascontiguousarray(iq.real, np.float32)
    xi = np.ascontiguousarray(iq.imag, np.float32)
    jpipe, tpipe = _pipelines()
    yr_r, yi_r, nf_r, ref = jpipe.forward_planes(jnp.asarray(xr),
                                                 jnp.asarray(xi))
    yr, yi, nf, got = tpipe.forward_planes(xr, xi)
    np.testing.assert_allclose(yr.numpy(), np.asarray(yr_r), atol=2e-5)
    np.testing.assert_allclose(yi.numpy(), np.asarray(yi_r), atol=2e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5)
    for field in EXACT:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=1e-5, atol=1e-6)
    # the planes step is the complex oracle step with the DFT extraction
    y = tchan.channelize(iq, tpipe.channelizer, method="dft", device="cpu")
    np.testing.assert_allclose(yr.numpy(), y.real.numpy(), atol=1e-6)
    np.testing.assert_allclose(yi.numpy(), y.imag.numpy(), atol=1e-6)


def test_extract_planes_and_extract_fused_of_floats_give_the_oracles_pdws():
    samples = pulse_capture(12)
    iq = iqpacket.to_complex(samples, 12)
    _, tpipe = _pipelines()
    kw = dict(fs=FS, fc=2.4e9, sample_start_time=1723800000.0)
    ref = tpipe.extract(iq, **kw)
    as_float = np.stack([iq.real, iq.imag], -1)
    for got in (tpipe.extract_planes(iq, **kw),
                tpipe.extract_fused(as_float, 0, **kw),
                tpipe.extract_fused(as_float.astype(np.float64), 0, **kw)):
        assert len(got["toa"]) == len(ref["toa"]) > 8
        for key in ("toa", "pw", "channel", "sat"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5,
                                   atol=1e-6)
        both_nan = np.isnan(got["freq"]) & np.isnan(ref["freq"])
        np.testing.assert_allclose(got["freq"][~both_nan],
                                   ref["freq"][~both_nan], rtol=0, atol=50.0)


def test_channelize_planes_is_the_dft_channelizer():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(M * 300) + 1j * rng.standard_normal(M * 300)
         ).astype(np.complex64)
    chan = tchan.Channelizer.create(M)
    yr, yi = tchan.channelize_planes(x.real.copy(), x.imag.copy(), chan,
                                     device="cpu")
    y = tchan.channelize(x, chan, method="dft", device="cpu")
    assert yr.shape == yi.shape == (300, M) and yr.dtype == torch.float32
    np.testing.assert_allclose(yr.numpy(), y.real.numpy(), atol=1e-6)
    np.testing.assert_allclose(yi.numpy(), y.imag.numpy(), atol=1e-6)
    assert ck.launches_complex == 0   # nothing here runs on a card
