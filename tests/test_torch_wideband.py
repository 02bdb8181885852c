"""The wideband path of the port (plain kernel versions on the CPU) against
the JAX package on the same captures: ``extract_pdws``,
``WidebandPdwPipeline``, the kernel tail without ready-made channel-major
streams, and blockwise extraction."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.models.pipeline import (
    WidebandPdwPipeline as JWideband,
)
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.signal.synth import (
    PulseTrainSpec,
    pulse_starts,
    pulse_train,
)
from sdr_channelizer_tpu_torch.cli.main import main
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
from sdr_channelizer_tpu_torch.ops import medians as tmedians
from sdr_channelizer_tpu_torch.signal import synth as tsynth
from torch_port_fixtures import PDW_FIELDS

torch.set_num_threads(1)

FS = 8e6
CFG_KW = dict(max_pulses=16, max_pulse_samples=512)
SPEC = PulseTrainSpec(sample_rate_sps=FS, duration_sec=2e-3,
                      frequency_hz=1.1e6, pulse_width_sec=40e-6,
                      pri_sec=250e-6, start_index=777, amplitude=0.5,
                      noise_std=2e-3)


def _capture():
    """16000 samples: eight pulses of 320 samples that clear 18 dB, one of
    them clipped, and two-sample spikes (the tiny tier)."""
    iq = np.ascontiguousarray(pulse_train(SPEC, seed=5), np.complex64)
    s = int(pulse_starts(SPEC)[3])
    iq[s + 10:s + 50] = 1.0 + 0.2j
    iq[300:302] = 0.4
    iq[9500] = 0.3j
    return iq


def _assert_batch_close(got, ref):
    """Exact keys equal; the float fields at the differences between
    ``torch`` and XLA in the last place of abs, angle and log10."""
    for field in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid",
                  "count"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            err_msg=field)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=2e-7, atol=0)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-5)
    f_got, f_ref = got.freq_offset_hz.numpy(), np.asarray(ref.freq_offset_hz)
    np.testing.assert_array_equal(np.isnan(f_got), np.isnan(f_ref))
    ok = ~np.isnan(f_ref)
    np.testing.assert_allclose(f_got[ok], f_ref[ok], rtol=3e-7, atol=1e-9)


@pytest.fixture(scope="module")
def jax_wideband():
    """The JAX package's wideband extraction of the capture, through its
    oracle tail and through its kernel tail (its latch, flip and statistics
    kernels in interpret mode), and the streams it made."""
    iq = _capture()
    cfg = JPdwConfig.wideband(**CFG_KW)
    x = jnp.asarray(iq)
    nf, oracle = JWideband(pdw_cfg=cfg).forward(x)
    streams = jpdw._prep_streams(x, cfg.saturation_level)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmedians, "use_sort_free", lambda: True)
        kernel = jpdw._extract_wideband_from_streams(
            *streams, cfg, nf, stats="pallas")
    return (iq, [np.asarray(s) for s in streams], np.asarray(nf), oracle,
            kernel)


@pytest.mark.parametrize("stats", ["auto", "xla", "pallas", "blocked"])
def test_extract_pdws_matches_jax(jax_wideband, stats):
    iq, _, _, oracle, _ = jax_wideband
    got = tpdw.extract_pdws(torch.from_numpy(iq), PdwConfig.wideband(**CFG_KW),
                            stats=stats)
    assert int(got.count) == len(pulse_starts(SPEC)) + 2
    assert bool(got.saturated.any())
    _assert_batch_close(got, oracle)


@pytest.mark.parametrize("field", PDW_FIELDS)
def test_kernel_tail_matches_jax_kernel_tail_on_jax_streams(jax_wideband,
                                                            field):
    """The same streams into both kernel tails: every field bit for bit
    (``snr_db`` at the last place of log10)."""
    _, streams, nf, _, ref = jax_wideband
    mag, ph, sat = (torch.from_numpy(s.copy()) for s in streams)
    got = tpdw._extract_wideband_from_streams(
        mag, ph, sat, PdwConfig.wideband(**CFG_KW),
        torch.from_numpy(nf.copy()), stats="pallas")
    g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
    assert g.shape == r.shape and g.dtype == r.dtype
    if field == "snr_db":
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(g, r)


def test_pipeline_forward_and_extract_match_jax(jax_wideband):
    iq, _, nf, oracle, _ = jax_wideband
    cfg = JPdwConfig.wideband(**CFG_KW)
    pipe = WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg), "cpu")
    assert dataclasses.asdict(pipe.pdw_cfg) == dataclasses.asdict(cfg)
    got_nf, got = pipe.forward(iq)
    np.testing.assert_allclose(got_nf.numpy(), nf, rtol=2e-7)
    _assert_batch_close(got, oracle)
    assert pipe.step(iq)[1].count == got.count
    kw = dict(fs=FS, fc=2.4e9, sample_start_time=100.0)
    ref = JWideband(pdw_cfg=cfg).extract(jnp.asarray(iq), **kw)
    p = pipe.extract(iq, **kw)
    assert set(p) == set(ref)
    for key in ("toa", "pw", "sat", "channel"):
        np.testing.assert_array_equal(p[key], ref[key], err_msg=key)
    np.testing.assert_allclose(p["mag"], ref["mag"], rtol=2e-7)
    np.testing.assert_allclose(p["snr"], ref["snr"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p["freq"], ref["freq"], rtol=0, atol=3.0)


def test_pipeline_recovers_the_generators_pulses():
    iq = np.ascontiguousarray(pulse_train(SPEC, seed=5), np.complex64)
    pipe = WidebandPdwPipeline(PdwConfig.wideband(**CFG_KW), device="cpu")
    for plain in (False, True):
        p = pipe.extract(iq, fs=FS, sample_start_time=10.0, plain=plain)
        starts = pulse_starts(SPEC)
        assert len(p["toa"]) == len(starts) == 8
        np.testing.assert_allclose((p["toa"] - 10.0) * FS, starts + 1,
                                   atol=1e-3)
        assert np.all(np.abs(p["pw"] * FS - SPEC.pw_samples) <= 8)
        assert np.all(np.abs(p["freq"] - SPEC.frequency_hz) < 2e3)
        assert np.all(p["snr"] > 20)


def test_planes_entries_match_the_complex_ones():
    iq = torch.from_numpy(_capture())
    cfg = PdwConfig.wideband(**CFG_KW)
    yr, yi = iq.real.contiguous(), iq.imag.contiguous()
    for stats in ("xla", "pallas"):
        a = tpdw.extract_pdws(iq, cfg, stats=stats)
        b = tpdw.extract_pdws_planes(yr, yi, cfg, stats=stats)
        for field in ("toa_idx", "te_idx", "saturated", "valid", "count"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field
        torch.testing.assert_close(a.mag, b.mag, rtol=2e-7, atol=0)
        torch.testing.assert_close(a.freq_offset_hz, b.freq_offset_hz,
                                   rtol=1e-5, atol=1e-8, equal_nan=True)
    ref = jpdw.extract_pdws_planes(jnp.asarray(yr.numpy()),
                                   jnp.asarray(yi.numpy()),
                                   JPdwConfig.wideband(**CFG_KW), stats="xla")
    _assert_batch_close(b, ref)


# ----------------------------------------------------------------- blocked

def _blocked_capture(blk):
    """Pulses that straddle both block boundaries, one that starts in the
    last halo, a clipped one, a sparse train, and one open at the end."""
    rng = np.random.default_rng(11)
    n = 3 * blk + 1500
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = (0.5 * np.exp(2j * np.pi * 0.137 * np.arange(400))
            ).astype(np.complex64)
    starts = [500, blk - 200, 2 * blk - 137, 3 * blk - 399, n - 1000]
    starts += [s for s in range(1300, n - 1100, 3511)
               if all(abs(s - b) > 450 for b in starts)]
    for s in starts:
        iq[s:s + 400] = tone
    iq[starts[1] + 50:starts[1] + 90] = 1.0   # clips across the boundary
    iq[n - 300:] = tone[:300]                  # open at the end
    return iq, sorted(starts)


@pytest.fixture(scope="module")
def blocked():
    blk = 4096
    iq, starts = _blocked_capture(blk)
    cfg = PdwConfig.wideband(max_pulses=16, max_pulse_samples=512)
    x = torch.from_numpy(iq)
    mag, ph, sat = tpdw._prep_streams(x, cfg.saturation_level)
    nf = tmedians.median(mag)
    got = tpdw._extract_wideband_blocked(mag, ph, sat, cfg, nf, block_len=blk)
    single = tpdw.extract_pdws(x, cfg, noise_floor=nf, stats="xla")
    return iq, starts, cfg, got, single, (mag, ph, sat, nf)


@pytest.mark.parametrize("field", PDW_FIELDS)
def test_blocked_matches_single_shot(blocked, field):
    _, starts, _, got, single, _ = blocked
    assert int(got.count) == len(starts)   # the open pulse is not emitted
    g, s = getattr(got, field), getattr(single, field)
    assert g.shape == s.shape and g.dtype == s.dtype
    if field in ("snr_db", "freq_offset_hz"):
        torch.testing.assert_close(g, s, rtol=3e-7, atol=2e-5)
    else:
        assert torch.equal(g, s), field


def test_blocked_emits_no_nan_and_keeps_the_open_pulse_out(blocked):
    iq, starts, _, got, _, _ = blocked
    v = got.valid
    np.testing.assert_array_equal(got.toa_idx[v].numpy(), starts)
    for field in ("mag", "snr_db", "freq_offset_hz", "pw_sec"):
        assert bool(torch.isfinite(getattr(got, field)).all()), field
    assert int(got.toa_idx.max()) < len(iq) - 300
    assert int(got.saturated.sum()) == 1
    assert not bool(got.valid[int(got.count):].any())


def test_kernel_tail_zeroes_the_pad_only_under_the_block_contract():
    """An infinite magnitude reaches the flip only outside the block
    contract; inside it the statistics streams see zero there."""
    seen = []

    def spy(mag, ph, sat):
        seen.append(bool(torch.isinf(mag).any()))
        return tpdw.kernels.cm_streams_plain(mag, ph, sat)

    ops = dataclasses.replace(tpdw.kernels.PLAIN, cm_streams=spy)
    cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=256)
    mag = torch.full((600, 1), 1e-3)
    mag[100:200] = 0.5
    mag[500:] = 0.5
    mag[-1] = float("inf")
    ph = torch.zeros_like(mag)
    sat = torch.zeros_like(mag, dtype=torch.bool)
    nf = torch.full((1,), 1e-3)
    batch = tpdw._extract_channelized_pallas_stats(
        mag, ph, sat, cfg, nf, entry_active=torch.zeros(1, dtype=torch.bool),
        own_len=599, ops=ops)
    assert int(batch.count[0]) == 1 and int(batch.toa_idx[0, 0]) == 100
    tpdw._extract_channelized_pallas_stats(mag, ph, sat, cfg, nf, ops=ops)
    assert seen == [False, True]


# ----------------------------------------------------------------- routing

def test_stats_values_and_the_routing_by_length(monkeypatch):
    cfg = PdwConfig.wideband(**CFG_KW)
    x = torch.from_numpy(_capture())
    with pytest.raises(ValueError, match="unknown stats"):
        tpdw.extract_pdws(x, cfg, stats="fast")
    calls = []
    sentinel = object()

    def fake_blocked(mag, phase_deg, sat, cfg, noise_floor, block_len=1 << 23,
                     ops=None):
        calls.append((int(mag.shape[0]), block_len))
        return sentinel

    monkeypatch.setattr(tpdw, "_extract_wideband_blocked", fake_blocked)
    long = torch.zeros(1).expand(1 << 24)   # 2^24 samples, no memory
    nf = torch.ones(())
    out = tpdw._extract_wideband_from_streams(long, long, long > 1, cfg, nf,
                                              stats="pallas")
    assert out is sentinel and calls == [(1 << 24, 1 << 23)]
    # on the CPU "auto" is the oracle tail, whatever the length
    short = torch.zeros(1).expand((1 << 24) - 1)
    assert tpdw._kernel_tail("auto", short) is False
    assert tpdw._kernel_tail("pallas", short) is True
    assert tpdw._kernel_tail("xla", short) is False


def test_cli_pdw_without_channelized_runs_wideband_on_the_cpu(tmp_path, capsys):
    spec = tsynth.PulseTrainSpec(sample_rate_sps=FS, duration_sec=2e-3,
                                 frequency_hz=1.1e6, pulse_width_sec=40e-6,
                                 pri_sec=250e-6, start_index=777,
                                 noise_std=3e-3)
    a, b = tmp_path / "a.iq", tmp_path / "b.iq"
    tsynth.write_training_iq(a, spec, sample_start_time=50.0)
    tsynth.write_training_iq(b, spec, sample_start_time=50.5, seed=1)
    out = tmp_path / "pdw.npz"
    assert main(["pdw", str(a), str(b), "--max-pulses", "16",
                 "--max-pulse-samples", "512", "--device", "cpu",
                 "--out", str(out)]) == 0
    assert "8 pulses" in capsys.readouterr().out
    p = np.load(out)
    assert set(p.files) == {"toa", "freq", "pw", "mag", "snr", "sat", "channel"}
    starts = tsynth.pulse_starts(spec)
    want = np.concatenate([50.0 + (starts + 1) / FS, 50.5 + (starts + 1) / FS])
    np.testing.assert_allclose(p["toa"], want, rtol=0, atol=1e-9)
    assert np.all(np.abs(p["pw"] - 40e-6) < 2e-6)
    assert np.all(np.abs(p["freq"] - 1.1e6) < 2e3)
    assert not p["channel"].any()
    # the threshold option reaches the wideband configuration
    assert main(["pdw", str(a), "--threshold-db", "60", "--device", "cpu",
                 "--out", str(out)]) == 0
    assert len(np.load(out)["toa"]) == 0
