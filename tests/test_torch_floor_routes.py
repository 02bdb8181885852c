"""The floors of the fused routes ``"cm"`` and ``"flat"``, of wideband
extraction and of the extractors called without a floor come through the
noise floor stage (``ops.noise_floor``: the kernel K2 on the card, its plain
version here), bit for bit the JAX package's ``medians.median`` at the same
places, and the PDWs are those of the sort-based floor they replace."""

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
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.models.pipeline import (
    ChannelizerPipeline,
    WidebandPdwPipeline,
)
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops import medians as tmedians
from sdr_channelizer_tpu_torch.signal.synth import PulseTrainSpec, pulse_train
from torch_port_fixtures import M, PDW_FIELDS, packed, pulse_capture

torch.set_num_threads(1)

CFG = JPdwConfig.channelized(max_pulses=64, max_pulse_samples=256)


def same_batch(a, b):
    for field in PDW_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0)), field


@pytest.fixture
def floors(monkeypatch):
    """Counts the calls of the noise floor stage of both stage sets."""
    calls = []
    for name in ("KERNELS", "PLAIN"):
        ops = getattr(kernels, name)

        def counted(mag_cm, t_len, fn=ops.noise_floor, name=name):
            calls.append((name, tuple(mag_cm.shape), t_len))
            return fn(mag_cm, t_len)

        monkeypatch.setattr(kernels, name,
                            dataclasses.replace(ops, noise_floor=counted))
    return calls


@pytest.fixture(scope="module")
def pipe():
    jpipe = JPipeline.create(M, pdw_cfg=CFG)
    return ChannelizerPipeline.from_reference(
        np.asarray(jpipe.channelizer.taps_rev), dataclasses.asdict(CFG),
        device="cpu")


@pytest.fixture(scope="module")
def xq():
    return packed(pulse_capture(12))


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("route", ["cm", "flat"])
def test_route_floor_is_the_stage_and_the_jax_median(floors, pipe, xq,
                                                     route, plain):
    nf, mag, batch = pipe.forward_packed(xq, 12, route=route, plain=plain)
    t_len = xq.size // M
    assert floors == [("PLAIN" if plain else "KERNELS", (M, t_len), t_len)]
    ref = np.asarray(jmedians.median(jnp.asarray(mag.numpy()), axis=0))
    np.testing.assert_array_equal(nf.numpy(), ref)
    assert int(batch.count.sum()) > 8


@pytest.mark.parametrize("route", ["cm", "flat"])
def test_route_pdws_are_those_of_the_sorted_floor(pipe, xq, route):
    """The step before the floor moved: ``median(mag, dim=0)`` over the
    time-major magnitude, and the tail's own flip on route ``flat``."""
    ops = kernels.PLAIN
    taps, cfg = pipe.channelizer.taps_rev, pipe.pdw_cfg
    nf, _, batch = pipe.forward_packed(xq, 12, route=route, plain=True)
    if route == "cm":
        mag, mag_cm, dph_cm, sat_cm = ops.channelize_cm(
            torch.from_numpy(xq), taps, bit_width=12,
            sat_level=cfg.saturation_level)
        old_nf = tmedians.median(mag, dim=0)
        old = pdwmod._extract_channelized_pallas_stats(
            mag, None, None, cfg, old_nf,
            cm_streams=(mag_cm, dph_cm, sat_cm), ops=ops)
    else:
        mag, ph, sat = ops.channelize_flat(
            torch.from_numpy(xq), taps, bit_width=12,
            sat_level=cfg.saturation_level)
        old_nf = tmedians.median(mag, dim=0)
        old = pdwmod._extract_channelized_pallas_stats(
            mag, ph, sat > 0.5, cfg, old_nf, ops=ops)
    assert torch.equal(nf, old_nf)
    same_batch(batch, old)


def test_routes_agree_with_cm2_on_the_floor(pipe, xq):
    nf2 = pipe.forward_packed(xq, 12, route="cm2", plain=True)[0]
    for route in ("cm", "flat"):
        assert torch.equal(pipe.forward_packed(xq, 12, route=route,
                                               plain=True)[0], nf2)


def _wideband_capture():
    spec = PulseTrainSpec(sample_rate_sps=8e6, duration_sec=2e-3,
                          frequency_hz=1.3e6, pulse_width_sec=40e-6,
                          pri_sec=400e-6, start_index=77, amplitude=0.5,
                          noise_std=1e-3)
    return np.asarray(pulse_train(spec, seed=4), np.complex64)


@pytest.mark.parametrize("plain", [True, False])
def test_wideband_floor_is_the_stage_and_the_jax_median(floors, plain):
    x = _wideband_capture()
    cfg = PdwConfig.wideband(max_pulses=32, max_pulse_samples=1024)
    nf, batch = WidebandPdwPipeline(cfg, device="cpu").forward(x, plain=plain)
    assert floors == [("PLAIN" if plain else "KERNELS", (1, x.size), x.size)]
    assert nf.shape == ()
    mag = torch.from_numpy(x).abs()
    ref = np.asarray(jmedians.median(jnp.asarray(mag.numpy())))
    assert nf.numpy() == ref
    # the PDWs of the sorted floor
    mag, ph, sat = pdwmod._prep_streams(torch.from_numpy(x),
                                        cfg.saturation_level)
    old = pdwmod._extract_wideband_from_streams(
        mag, ph, sat, cfg, tmedians.median(mag), ops=kernels.PLAIN)
    same_batch(batch, old)
    assert int(batch.count) >= 4


@pytest.mark.parametrize("stats", ["pallas", "xla"])
def test_wideband_extractors_without_a_floor(floors, stats):
    x = torch.from_numpy(_wideband_capture())
    cfg = PdwConfig.wideband(max_pulses=32, max_pulse_samples=1024)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    # the stage set that the entry points take by default, as patched
    ops = kernels.KERNELS
    a = pdwmod.extract_pdws(x, cfg, stats=stats, ops=ops)
    b = pdwmod.extract_pdws_planes(xr, xi, cfg, stats=stats, ops=ops)
    assert floors == [("KERNELS", (1, x.numel()), x.numel())] * 2
    same_batch(a, pdwmod.extract_pdws(x, cfg, noise_floor=tmedians.median(
        x.abs()), stats=stats))
    mag_planes = pdwmod._prep_streams_planes(xr, xi, 1.0)[0]
    same_batch(b, pdwmod.extract_pdws_planes(
        xr, xi, cfg, noise_floor=tmedians.median(mag_planes), stats=stats))


def test_channelized_extractors_without_a_floor(floors, pipe, xq):
    ops = kernels.PLAIN
    taps, cfg = pipe.channelizer.taps_rev, pipe.pdw_cfg
    mag, mag_cm, dph_cm, sat_cm = ops.channelize_cm(
        torch.from_numpy(xq), taps, bit_width=12,
        sat_level=cfg.saturation_level)
    _, ph, sat = ops.channelize_flat(torch.from_numpy(xq), taps, bit_width=12,
                                     sat_level=cfg.saturation_level)
    floor = tmedians.median(mag, dim=0)
    ops = kernels.KERNELS   # as patched
    a = pdwmod.extract_pdws_channelized_streams_cm(mag, mag_cm, dph_cm,
                                                   sat_cm, cfg, ops=ops)
    b = pdwmod.extract_pdws_channelized_streams(mag, ph, sat > 0.5, cfg,
                                                stats="pallas", ops=ops)
    c = pdwmod.extract_pdws_channelized_streams(mag, ph, sat > 0.5, cfg,
                                                stats="xla", ops=ops)
    # the kernel tail takes the stage on the flip; the oracle tail sorts
    assert floors == [("KERNELS", tuple(mag_cm.shape), mag.shape[0])] * 2
    same_batch(a, pdwmod.extract_pdws_channelized_streams_cm(
        mag, mag_cm, dph_cm, sat_cm, cfg, noise_floor=floor))
    same_batch(b, pdwmod._extract_channelized_pallas_stats(
        mag, ph, sat > 0.5, cfg, floor))
    same_batch(c, pdwmod.extract_pdws_channelized_streams(
        mag, ph, sat > 0.5, cfg, noise_floor=floor, stats="xla"))


def test_the_oracle_routes_keep_the_sort(floors, pipe, xq):
    """``forward`` and ``forward_planes`` are the CPU oracle's: no stage."""
    samples = pulse_capture(12)
    iq = iqpacket.to_complex(samples, 12)
    pipe.forward(iq)
    pipe.forward_planes(iq.real.astype(np.float32),
                        iq.imag.astype(np.float32))
    assert floors == []
