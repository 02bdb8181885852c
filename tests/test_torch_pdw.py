"""The port's PDW stage against the JAX package: rank search, medians, the
channel-major extraction fed the JAX streams, and the host finalize.  The
block contract has its own file, ``test_torch_pdw_blocks.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.ops import rank_find as jrank
from sdr_channelizer_tpu.ops.pallas.channelizer_kernel import (
    pallas_channelize_streams_packed_cm2,
)
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.ops import medians as tmedians
from sdr_channelizer_tpu_torch.ops import rank_find as trank
from torch_port_fixtures import (
    PDW_FIELDS as FIELDS,
    M,
    assert_pdw_field as _assert_field,
    packed,
    pulse_capture,
)

torch.set_num_threads(1)

CFG_KW = dict(max_pulses=64, max_pulse_samples=256)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX streams, noise floor and batch of one clipped capture: one
    interpret-mode run of the channelizer, latch and statistics kernels."""
    xq = packed(pulse_capture(12))
    t_len = len(xq) // M
    taps = JChannelizer.create(M).taps_rev
    streams = pallas_channelize_streams_packed_cm2(
        jnp.asarray(xq), taps, bit_width=12, block_frames=256, interpret=True)
    nf = jpdw.noise_floor_cm(streams[0], M, t_len)
    cfg = JPdwConfig.channelized(**CFG_KW)
    batch = jpdw._extract_channelized_cm2(*streams, cfg, nf, t_len, M)
    return ([np.asarray(s) for s in streams], np.asarray(nf), batch, t_len)


@pytest.fixture(scope="module")
def port_batch(jax_run):
    streams, nf, _, t_len = jax_run
    return tpdw._extract_channelized_cm2(
        *(torch.from_numpy(s.copy()) for s in streams),
        PdwConfig.channelized(**CFG_KW), torch.from_numpy(nf.copy()), t_len, M)


@pytest.mark.parametrize("field", FIELDS)
def test_extract_cm2_matches_jax_on_jax_streams(jax_run, port_batch, field):
    ref = np.asarray(getattr(jax_run[2], field))
    got = getattr(port_batch, field).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    _assert_field(field, got, ref)


def test_extract_cm2_exercises_every_tier(jax_run, port_batch):
    plen = (port_batch.te_idx - port_batch.toa_idx + 1)[port_batch.valid]
    assert int(port_batch.count.sum()) > 8
    assert bool((plen <= 2).any()) and bool((plen > 2).any())
    assert bool(port_batch.saturated.any())


def test_noise_floor_cm_matches_jax(jax_run):
    streams, nf, _, t_len = jax_run
    got = tpdw.noise_floor_cm(torch.from_numpy(streams[0].copy()), M, t_len)
    np.testing.assert_array_equal(got.numpy(), nf)


def test_finalize_matches_jax(jax_run, port_batch):
    kw = dict(fs=1e6, fc=2.4e9, sample_start_time=1723800000.25,
              bin_offsets_hz=np.linspace(-4e6, 3e6, M))
    ref = jpdw.finalize_pdws(jax_run[2], **kw)
    same_batch = tpdw.PdwBatch(**{
        f: torch.from_numpy(np.array(getattr(jax_run[2], f))) for f in FIELDS})
    got = tpdw.finalize_pdws(same_batch, **kw)
    assert len(got["toa"]) == int(port_batch.count.sum())
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_long_tier_and_open_pulse_match_jax():
    """Pulses past the short window, and one left open at the end."""
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

    spec = PulseTrainSpec(sample_rate_sps=8e6, duration_sec=2e-3,
                          frequency_hz=1.7e6, pulse_width_sec=400e-6,
                          pri_sec=900e-6, start_index=101, noise_std=5e-3)
    iq = pulse_train(spec, seed=9)
    iq[-500:] = iq[200:700]  # re-open a pulse at capture end
    samples = iqpacket.from_complex(iq, 12)
    xq = packed(samples[: len(iq) // M * M])
    t_len = len(xq) // M
    streams = pallas_channelize_streams_packed_cm2(
        jnp.asarray(xq), JChannelizer.create(M).taps_rev, bit_width=12,
        block_frames=256, interpret=True)
    nf = jpdw.noise_floor_cm(streams[0], M, t_len)
    kw = dict(max_pulses=16, max_pulse_samples=512)
    ref = jpdw._extract_channelized_cm2(
        *streams, JPdwConfig.channelized(**kw), nf, t_len, M)
    got = tpdw._extract_channelized_cm2(
        *(torch.from_numpy(np.array(s)) for s in streams),
        PdwConfig.channelized(**kw), torch.from_numpy(np.array(nf)),
        t_len, M)
    plen = (got.te_idx - got.toa_idx + 1)[got.valid]
    assert bool((plen > 128).any())
    # the open pulse has a leading edge and no trailing edge: not emitted
    assert int(got.count.sum()) == int(np.asarray(ref.count).sum())
    for field in FIELDS:
        _assert_field(field, getattr(got, field).numpy(),
                      np.asarray(getattr(ref, field)))


def test_find_ranks_cm_matches_jax():
    rng = np.random.default_rng(4)
    t_len, t_arr = 1000, 1024
    edges = rng.random((6, t_arr)) < 0.02
    edges[:, t_len:] = False
    cum = np.cumsum(edges, axis=1).astype(np.float32)
    ranks = np.broadcast_to(np.arange(1, 41, dtype=np.float32), (6, 40)).copy()
    ranks[3] += 1.0  # an entry-active row skips its first edge
    ref = jrank.find_ranks_cm(jnp.asarray(cum), jnp.asarray(ranks), t_len,
                              block=256)
    got = trank.find_ranks_cm(torch.from_numpy(cum), torch.from_numpy(ranks),
                              t_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == t_len).any() and (got.numpy() < t_len).any()


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_median_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)).astype(np.float32)
    ref = np.asarray(jmedians.median(jnp.asarray(x), axis=1))
    got = tmedians.median(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, ref)
    if n % 2 == 0:
        return  # the JAX select lets a NaN above the middle into its min
    x[0, 0] = np.nan  # NaNs sort high, as in the JAX radix select
    ref = np.asarray(jmedians.median(jnp.asarray(x), axis=1, method="select"))
    got = tmedians.median(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_masked_median_matches_jax():
    rng = np.random.default_rng(8)
    x = np.round(rng.standard_normal((9, 33)) * 4).astype(np.float32) / 4
    mask = rng.random((9, 33)) < 0.5
    mask[0] = False  # empty -> NaN
    mask[1] = True
    ref = np.asarray(jmedians.masked_median(jnp.asarray(x), jnp.asarray(mask),
                                            axis=1))
    got = tmedians.masked_median(torch.from_numpy(x), torch.from_numpy(mask),
                                 dim=1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[0])


def test_sortable_keys_order_and_round_trip():
    x = torch.tensor([-np.inf, -2.5, -0.0, 0.0, 1e-30, 3.0, np.inf, np.nan])
    keys = tmedians.sortable_u32(x)
    assert bool((keys[1:] > keys[:-1]).all())
    back = tmedians.u32_to_f32(keys)
    assert torch.equal(back[:-1], x[:-1]) and torch.isnan(back[-1])


def test_oracle_core_matches_jax_core():
    """The two-bit oracle extractor on (T, M) streams, thresholds hit
    exactly included (it toggles there, as the JAX scan does)."""
    rng = np.random.default_rng(17)
    t_len, m = 600, 3
    mag = (0.01 * np.abs(rng.standard_normal((t_len, m)))).astype(np.float32)
    for s in (50, 200, 330, 480):
        mag[s:s + 40] += 0.5
    ph = rng.uniform(-180, 180, (t_len, m)).astype(np.float32)
    sat = rng.random((t_len, m)) < 0.02
    nf = np.full(m, 0.01, np.float32)
    mag[100:103, 1] = np.float32(0.01) * np.float32(10.0 ** 1.5)
    kw = dict(max_pulses=8, max_pulse_samples=64)
    ref = jpdw.extract_pdws_channelized_streams(
        jnp.asarray(mag), jnp.asarray(ph), jnp.asarray(sat),
        JPdwConfig.channelized(**kw), jnp.asarray(nf), stats="xla")
    got = tpdw.extract_pdws_channelized_streams(
        torch.from_numpy(mag), torch.from_numpy(ph), torch.from_numpy(sat),
        PdwConfig.channelized(**kw), torch.from_numpy(nf))
    for field in ("toa_idx", "te_idx", "pw_sec", "mag", "saturated", "valid",
                  "count"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            err_msg=field)
    assert int(got.count.sum()) >= 12
    # XLA folds the division by 360 into the median's mean: last place
    np.testing.assert_allclose(got.freq_offset_hz.numpy(),
                               np.asarray(ref.freq_offset_hz), rtol=3e-7,
                               atol=0)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-5)


def test_config_matches_jax_package():
    for name in ("channelized", "wideband", "event"):
        assert (dataclasses.asdict(getattr(PdwConfig, name)())
                == dataclasses.asdict(getattr(JPdwConfig, name)()))


def test_take_at_cm_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((6, 1024)).astype(np.float32)
    chan = rng.integers(0, 6, 40).astype(np.int32)
    idx = rng.integers(0, 1000, 40).astype(np.int32)
    ref = jrank.take_at_cm(jnp.asarray(vals), jnp.asarray(chan),
                           jnp.asarray(idx))
    got = trank.take_at_cm(torch.from_numpy(vals), torch.from_numpy(chan),
                           torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
