"""The slice as a whole: the port's packed main path (plain kernel versions
on the CPU) against the JAX package's CPU oracle and its cm2 route, and
against the generator's ground truth."""

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
from sdr_channelizer_tpu.signal.synth import (
    PulseTrainSpec,
    pulse_starts,
    pulse_train,
)
from sdr_channelizer_tpu_torch.models.pipeline import ChannelizerPipeline
from torch_port_fixtures import M, packed, pulse_capture

torch.set_num_threads(1)

FS = 8e6
CFG = JPdwConfig.channelized(max_pulses=64, max_pulse_samples=256)


def _pipelines():
    """The JAX pipeline and the port's, built from the JAX one's values."""
    jpipe = JPipeline.create(M, pdw_cfg=CFG)
    tpipe = ChannelizerPipeline.from_reference(
        np.asarray(jpipe.channelizer.taps_rev), dataclasses.asdict(CFG),
        device="cpu")
    return jpipe, tpipe


def _sparse_capture(n=M * 4096):
    """The sparse benchmark capture cut to M = 8: noise plus two pulsed,
    bin-centred tones 24 dB over the channel noise floor, as Q11 int16."""
    rng = np.random.default_rng(0)
    t = np.arange(n)
    iq = (0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    for k, (f0, pw, pri) in enumerate([(1.0e6, 100e-6, 1e-3),
                                       (-3.0e6, 50e-6, 0.7e-3)]):
        tone = (0.02 * np.exp(2j * np.pi * f0 / FS * t)).astype(np.complex64)
        pw_n, pri_n = int(pw * FS), int(pri * FS)
        for s in range(137 + k * 1000, n - pw_n, pri_n):
            iq[s:s + pw_n] = tone[s:s + pw_n]
    return np.clip(np.round(np.stack([iq.real, iq.imag], -1) * 2048),
                   -2048, 2047).astype(np.int16)


def _assert_pdws_close(got, ref):
    """The JAX package's own bars between two of its routes."""
    assert len(got["toa"]) == len(ref["toa"]) > 0
    np.testing.assert_array_equal(got["channel"], ref["channel"])
    np.testing.assert_array_equal(got["sat"], ref["sat"])
    np.testing.assert_allclose(got["toa"], ref["toa"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    both_nan = np.isnan(got["freq"]) & np.isnan(ref["freq"])
    np.testing.assert_allclose(got["freq"][~both_nan], ref["freq"][~both_nan],
                               rtol=0, atol=50.0)


@pytest.mark.parametrize("capture", ["synth", "synth_clipped", "sparse"])
def test_extract_fused_matches_jax_cpu_oracle(capture):
    if capture == "sparse":
        samples = _sparse_capture()
    else:
        samples = pulse_capture(12, clip=capture == "synth_clipped")
    jpipe, tpipe = _pipelines()
    kw = dict(fs=FS, fc=2.4e9, sample_start_time=1723800000.0)
    ref = jpipe.extract(jnp.asarray(iqpacket.to_complex(samples, 12)), **kw)
    got = tpipe.extract_fused(samples, bit_width=12, **kw)
    _assert_pdws_close(got, ref)
    if capture == "synth_clipped":
        assert got["sat"].any()
    if capture == "sparse":
        # exactly the generated pulses, in the two tones' channels
        assert sorted(set(got["channel"])) == [1, 5]
        assert len(got["toa"]) == 4 + 6


def test_port_oracle_route_matches_its_main_path():
    samples = pulse_capture(12)
    _, tpipe = _pipelines()
    a = tpipe.extract_fused(samples, bit_width=12, fs=FS)
    b = tpipe.extract(iqpacket.to_complex(samples, 12), fs=FS)
    _assert_pdws_close(a, b)


@pytest.mark.parametrize("bit_width", [12, 8])
def test_forward_packed_matches_jax_cm2_route(monkeypatch, bit_width):
    """One interpret-mode run of the JAX cm2 route per payload type."""
    samples = pulse_capture(bit_width)
    xq = packed(samples)
    jpipe, tpipe = _pipelines()
    monkeypatch.setattr(jmedians, "use_sort_free", lambda: True)
    nf_r, mag_r, ref = jpipe.forward_packed(jnp.asarray(xq),
                                            bit_width=bit_width, route="cm2")
    nf, mag_cm, got = tpipe.forward_packed(xq, bit_width, route="cm2")
    t_len = len(xq) // M
    assert mag_cm.shape == (M, t_len)
    np.testing.assert_allclose(mag_cm.numpy(),
                               np.asarray(mag_r)[:M, :t_len],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5)
    assert int(got.count.sum()) > 8
    for field in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid",
                  "count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-3)
    # 50 Hz at the decimated rate, in cycles per sample; NaN for one-sample
    # pulses on both sides
    f_got, f_ref = got.freq_offset_hz.numpy(), np.asarray(ref.freq_offset_hz)
    np.testing.assert_array_equal(np.isnan(f_got), np.isnan(f_ref))
    ok = ~np.isnan(f_ref)
    np.testing.assert_allclose(f_got[ok], f_ref[ok], rtol=0,
                               atol=50.0 / (FS / M))


def test_recovers_the_generators_pulses():
    """TOA, width and PRI of the tone's pulses against the spec.  Two traps:
    a noise-free capture has a zero floor and emits nothing, so the spec
    has noise; edge transients in far bins are real detections, so the
    comparison filters to the tone's own bin."""
    spec = PulseTrainSpec(sample_rate_sps=FS, duration_sec=2e-3,
                          frequency_hz=2.0e6, pulse_width_sec=100e-6,
                          pri_sec=500e-6, start_index=1234, noise_std=3e-3)
    samples = iqpacket.from_complex(pulse_train(spec, seed=0), 12)
    _, tpipe = _pipelines()
    p = tpipe.extract_fused(samples, bit_width=12, fs=FS,
                            sample_start_time=100.0)
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - spec.frequency_hz) < 0.5e6)
    starts = pulse_starts(spec)
    assert int(sel.sum()) == len(starts) == 4
    assert set(p["channel"][sel]) == {M // 2 + 2}
    delay = 12 * M / FS  # the prototype filter's length
    toa = p["toa"][sel] - 100.0
    assert np.all(np.abs(toa - (starts + 1) / FS) < delay)
    assert np.all(np.abs(p["pw"][sel] - spec.pulse_width_sec) < delay)
    np.testing.assert_allclose(np.diff(toa), spec.pri_sec, atol=2 * M / FS)
    assert np.all(np.abs(p["freq"][sel] - spec.frequency_hz) < 1e3)


@pytest.mark.parametrize("route", ["cm", "flat", "cm2c", "cm2g"])
def test_routes_run_and_the_ab_knobs_do_not_carry_over(route):
    """The cm and flat routes are ported and run; the two A/B knobs of the
    JAX package's cm2 tail do not carry over and say so."""
    _, tpipe = _pipelines()
    xq = packed(pulse_capture(12))
    if route in ("cm", "flat"):
        nf, mag, batch = tpipe.forward_packed(xq, 12, route=route)
        assert mag.shape == (len(xq) // M, M) and nf.shape == (M,)
        assert int(batch.count.sum()) > 8
        return
    with pytest.raises(NotImplementedError, match="does not carry over"):
        tpipe.forward_packed(xq, 12, route=route)
    with pytest.raises(NotImplementedError, match="does not carry over"):
        tpipe.forward_fused(np.zeros(64, np.float32), np.zeros(64, np.float32),
                            route=route)


def test_unknown_route_and_bad_payloads_are_rejected_float_ones_taken():
    """An unknown route and a payload that is no (N, 2) integer or float
    buffer are rejected; a float payload itself is taken (as planes)."""
    _, tpipe = _pipelines()
    with pytest.raises(ValueError):
        tpipe.forward_packed(packed(pulse_capture(12)), 12, route="nope")
    with pytest.raises(ValueError):
        tpipe.extract_fused(np.zeros((64, 3), np.float32), 0, fs=FS)
    with pytest.raises(TypeError):
        tpipe.extract_fused(np.zeros((64, 2), np.uint32), 12, fs=FS)
    samples = pulse_capture(12)
    got = tpipe.extract_fused(samples.astype(np.float32) / 2048.0, 0, fs=FS)
    ref = tpipe.extract_fused(samples, 12, fs=FS)
    _assert_pdws_close(got, ref)


def test_from_reference_carries_the_parameters_across():
    jpipe, tpipe = _pipelines()
    np.testing.assert_array_equal(tpipe.channelizer.taps_rev,
                                  jpipe.channelizer.taps_rev)
    assert tpipe.channelizer.num_bands == M
    assert dataclasses.asdict(tpipe.pdw_cfg) == dataclasses.asdict(CFG)
    own = ChannelizerPipeline.create(M, device="cpu")
    np.testing.assert_array_equal(own.channelizer.taps_rev,
                                  jpipe.channelizer.taps_rev)
