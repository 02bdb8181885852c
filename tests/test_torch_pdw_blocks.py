"""The block contract of the port's PDW stage against the JAX package:
latch transfer functions and their composition, the oracle block extractor,
and the two kernel tails given an entry state, an owned length and a right
halo, on streams made by the JAX kernels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.ops.pallas.channelizer_kernel import (
    pallas_channelize_streams_packed_cm,
    pallas_channelize_streams_packed_cm2,
)
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.ops import medians as tmedians
from torch_port_fixtures import (
    PDW_FIELDS as FIELDS,
    M,
    assert_pdw_field as _assert_field,
    packed,
    pulse_capture,
)

torch.set_num_threads(1)

CFG_KW = dict(max_pulses=64, max_pulse_samples=256)


def _latch_bits(seed=11, shape=(3, 400)):
    """Random threshold outcomes with set, reset, hold and toggle samples."""
    rng = np.random.default_rng(seed)
    ge = rng.random(shape) < 0.1
    le = rng.random(shape) < 0.2
    ge[:, 50:53] = le[:, 50:53] = True    # toggles in a row
    ge[1, :40] = le[1, :40] = False       # a long hold at the start
    return ge, le


@pytest.mark.parametrize("dim", [-1, 0])
def test_hysteresis_fns_match_jax(dim):
    ge, le = _latch_bits()
    if dim == 0:
        ge, le = ge.T.copy(), le.T.copy()
    ref = jpdw.hysteresis_fns(jnp.asarray(ge), jnp.asarray(le), axis=dim)
    got = tpdw.hysteresis_fns(torch.from_numpy(ge), torch.from_numpy(le),
                              dim=dim)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    a, b = (x.numpy() for x in got)
    assert (a != b).any() and (a == b).any()
    np.testing.assert_array_equal(
        tpdw.hysteresis_scan(torch.from_numpy(ge.T if dim == 0 else ge),
                             torch.from_numpy(le.T if dim == 0 else le)
                             ).numpy(), a.T if dim == 0 else a)


def test_compose_transfer_matches_jax_and_chains_blocks():
    ge, le = _latch_bits(seed=12)
    tge, tle = torch.from_numpy(ge), torch.from_numpy(le)
    whole = tuple(x[:, -1] for x in tpdw.hysteresis_fns(tge, tle))
    first = tuple(x[:, -1] for x in tpdw.hysteresis_fns(tge[:, :170],
                                                        tle[:, :170]))
    second = tuple(x[:, -1] for x in tpdw.hysteresis_fns(tge[:, 170:],
                                                         tle[:, 170:]))
    got = tpdw.compose_transfer(first, second)
    ref = jpdw.compose_transfer(tuple(jnp.asarray(x.numpy()) for x in first),
                                tuple(jnp.asarray(x.numpy()) for x in second))
    for g, r, w in zip(got, ref, whole):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert torch.equal(g, w)
    ident = (torch.zeros(3, dtype=torch.bool), torch.ones(3, dtype=torch.bool))
    for g, f in zip(tpdw.compose_transfer(ident, first), first):
        assert torch.equal(g, f)


def _oracle_streams(seed=17, t_len=900, m=3):
    """(T, M) streams for the oracle extractors: pulses of several lengths,
    one across each of the cuts used below, one open at the end."""
    rng = np.random.default_rng(seed)
    mag = (0.01 * np.abs(rng.standard_normal((t_len, m)))).astype(np.float32)
    for s, w in ((50, 40), (280, 45), (330, 2), (480, 30), (590, 40),
                 (700, 1), (760, 60)):
        mag[s:s + w] += 0.5
    mag[880:, 1] += 0.5
    ph = rng.uniform(-180, 180, (t_len, m)).astype(np.float32)
    sat = rng.random((t_len, m)) < 0.02
    return mag, ph, sat, np.full(m, 0.01, np.float32)


@pytest.mark.parametrize("trailing", [None, 9.0])
def test_block_transfer_matches_jax(trailing):
    mag, _, _, nf = _oracle_streams()
    ref = jpdw.block_transfer(jnp.asarray(mag.T), jnp.asarray(nf)[:, None],
                              15.0, trailing)
    got = tpdw.block_transfer(torch.from_numpy(mag.T.copy()),
                              torch.from_numpy(nf)[:, None], 15.0, trailing)
    for g, r in zip(got, ref):
        assert g.shape == (3,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0][1] and got[1][1]        # the pulse open at the end


ORACLE_KW = dict(max_pulses=8, max_pulse_samples=64)


def _block_core_pair(f0, own, halo, entry):
    """The same block through the JAX oracle (one channel at a time, as it
    is written) and through the port's (batched over channels)."""
    import jax

    mag, ph, sat, nf = _oracle_streams()
    sl = slice(f0, f0 + own + halo)
    jcfg = JPdwConfig.channelized(**ORACLE_KW)
    core = lambda a, b, c, d, e: jpdw.extract_pdws_block_core(  # noqa: E731
        a, b, c, d, e, own_len=own, snr_threshold_db=jcfg.snr_threshold_db,
        trailing_threshold_db=jcfg.trailing_threshold_db,
        max_pulses=jcfg.max_pulses, max_pulse_samples=jcfg.max_pulse_samples)
    ref = jax.vmap(core, in_axes=(1, 1, 1, 0, 0))(
        jnp.asarray(mag[sl]), jnp.asarray(ph[sl]), jnp.asarray(sat[sl]),
        jnp.asarray(nf), jnp.asarray(entry))
    got = tpdw.extract_pdws_block_core(
        torch.from_numpy(mag[sl].T.copy()), torch.from_numpy(ph[sl].T.copy()),
        torch.from_numpy(sat[sl].T.copy()), torch.from_numpy(nf),
        torch.from_numpy(entry), own, PdwConfig.channelized(**ORACLE_KW))
    return got, ref


@pytest.mark.parametrize("field", FIELDS)
def test_block_core_matches_jax(field):
    """A block entered inside a pulse, with one pulse across its right edge
    and one that starts in the halo."""
    entry = np.array([True, True, False])   # channel 2: forced inactive
    got, ref = _block_core_pair(f0=300, own=300, halo=100, entry=entry)
    g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
    assert g.shape == r.shape and g.dtype == r.dtype
    if field == "freq_offset_hz":
        # XLA folds the division by 360 into the median's mean: last place
        np.testing.assert_allclose(g, r, rtol=3e-7, atol=0)
    else:
        _assert_field(field, g, r)
    if field == "count":
        # 330, 480, 590 owned (590 closes in the halo); 280 was the entry
        # pulse; 700 lies in the halo
        np.testing.assert_array_equal(g[:2], [3, 3])


def test_oracle_blocks_concatenate_to_the_whole_capture():
    mag, ph, sat, nf = _oracle_streams()
    cfg = PdwConfig.channelized(**ORACLE_KW)
    t = lambda x: torch.from_numpy(x.T.copy())  # noqa: E731
    whole = tpdw.extract_pdws_core(t(mag), t(ph), t(sat),
                                   torch.from_numpy(nf), cfg)
    entry = torch.zeros(3, dtype=torch.bool)
    rows = [[] for _ in range(3)]
    for f0 in (0, 300, 600):
        end = f0 + 300 == 900
        sl = slice(f0, f0 + 300 + (0 if end else 100))
        streams = [t(mag[sl]), t(ph[sl]), t(sat[sl])]
        if end:   # the capture ends here: +inf keeps an open pulse open
            pad = (torch.full((3, 1), float("inf")), torch.zeros((3, 1)),
                   torch.zeros((3, 1), dtype=torch.bool))
            streams = [torch.cat([s, p_], 1) for s, p_ in zip(streams, pad)]
        b = tpdw.extract_pdws_block_core(*streams, torch.from_numpy(nf),
                                         entry, 300, cfg)
        a_blk, b_blk = tpdw.block_transfer(
            t(mag[f0:f0 + 300]), torch.from_numpy(nf)[:, None],
            cfg.snr_threshold_db, cfg.trailing_threshold_db)
        entry = torch.where(entry, b_blk, a_blk)
        for c in range(3):
            v = b.valid[c]
            rows[c].append(torch.stack([
                (b.toa_idx[c][v] + f0).float(), (b.te_idx[c][v] + f0).float(),
                b.mag[c][v], b.freq_offset_hz[c][v],
                b.saturated[c][v].float()], 1))
    for c in range(3):
        v = whole.valid[c]
        ref = torch.stack([whole.toa_idx[c][v].float(),
                           whole.te_idx[c][v].float(), whole.mag[c][v],
                           whole.freq_offset_hz[c][v],
                           whole.saturated[c][v].float()], 1)
        got = torch.cat(rows[c])
        assert got.shape == ref.shape and got.shape[0] >= 6
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


BLK_F0, BLK_OWN, BLK_HALO = 340, 400, 256


@pytest.fixture(scope="module")
def jax_block():
    """One streamed block the way the JAX package runs it: the cm form of
    its channelizer kernel with the history of the frames before, then its
    kernel tail with the block contract (interpret mode, its kernel route
    switched on).  The block starts inside a pulse of the tone's channel,
    holds a clipped pulse, and one pulse starts in its halo."""
    samples = pulse_capture(12, clip=False)
    samples[5000:5040] = 2047
    xq = packed(samples)
    chan = JChannelizer.create(M)
    p = chan.taps_per_band
    t_blk = BLK_OWN + BLK_HALO
    whole = pallas_channelize_streams_packed_cm2(
        jnp.asarray(xq), chan.taps_rev, bit_width=12, block_frames=256,
        interpret=True)
    nf = jpdw.noise_floor_cm(whole[0], M, len(xq) // M)
    cfg = JPdwConfig.channelized(**CFG_KW)
    a, b = jpdw.block_transfer(whole[0][:M, :BLK_F0], nf[:, None],
                               cfg.snr_threshold_db, cfg.trailing_threshold_db)
    entry = a   # the capture starts inactive
    streams = pallas_channelize_streams_packed_cm(
        jnp.asarray(xq[BLK_F0 * M:(BLK_F0 + t_blk) * M]), chan.taps_rev,
        bit_width=12, block_frames=256, interpret=True,
        history=jnp.asarray(xq[(BLK_F0 - (p - 1)) * M: BLK_F0 * M]))
    mag = streams[0][:t_blk]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmedians, "use_sort_free", lambda: True)
        batch = jpdw._extract_channelized_pallas_stats(
            mag, None, None, cfg, nf, entry_active=entry, own_len=BLK_OWN,
            cm_streams=streams[1:])
        whole_blk = jpdw.extract_pdws_channelized_streams_cm(
            mag, *streams[1:], cfg, nf)
    cut = [np.asarray(mag)] + [np.asarray(s)[:M, :t_blk].copy()
                               for s in streams[1:]]
    return cut, np.asarray(nf), np.asarray(entry), batch, whole_blk


def _port_block(jax_block, **kw):
    cut, nf, entry, _, _ = jax_block
    mag, mag_cm, dph_cm, sat_cm = (torch.from_numpy(c.copy()) for c in cut)
    return tpdw._extract_channelized_pallas_stats(
        mag, None, None, PdwConfig.channelized(**CFG_KW),
        torch.from_numpy(nf.copy()), cm_streams=(mag_cm, dph_cm, sat_cm),
        **kw)


@pytest.mark.parametrize("field", FIELDS)
def test_block_kernel_tail_matches_jax_on_jax_streams(jax_block, field):
    entry = torch.from_numpy(jax_block[2].copy())
    got = _port_block(jax_block, entry_active=entry, own_len=BLK_OWN)
    ref = np.asarray(getattr(jax_block[3], field))
    g = getattr(got, field).numpy()
    assert g.shape == ref.shape and g.dtype == ref.dtype
    _assert_field(field, g, ref)


def test_block_kernel_tail_saw_the_contract(jax_block):
    entry = jax_block[2]
    assert entry.any() and not entry.all()
    got = _port_block(jax_block, entry_active=torch.from_numpy(entry.copy()),
                      own_len=BLK_OWN)
    free = _port_block(jax_block)
    c = int(np.flatnonzero(entry)[0])
    # entered active: the first trailing edge closes the earlier block's
    # pulse and no pulse is emitted for it; the pulse that starts in the
    # halo belongs to the next block
    assert int(got.count[c]) >= 1
    assert int(got.toa_idx[c][got.valid[c]].max()) < BLK_OWN
    assert int(free.toa_idx[c][free.valid[c]].max()) >= BLK_OWN
    assert bool(got.saturated.any())
    plen = (got.te_idx - got.toa_idx + 1)[got.valid]
    assert bool((plen <= 2).any()) and bool((plen > 2).any())


@pytest.mark.parametrize("field", FIELDS)
def test_streams_cm_entry_matches_jax(jax_block, field):
    """The public entry: the whole block owned, the latch starting
    inactive, the noise floor given."""
    cut, nf, _, _, ref = jax_block
    mag, mag_cm, dph_cm, sat_cm = (torch.from_numpy(c.copy()) for c in cut)
    got = tpdw.extract_pdws_channelized_streams_cm(
        mag, mag_cm, dph_cm, sat_cm, PdwConfig.channelized(**CFG_KW),
        torch.from_numpy(nf.copy()))
    _assert_field(field, getattr(got, field).numpy(),
                  np.asarray(getattr(ref, field)))


def test_streams_cm_default_floor_is_the_blocks_median(jax_block):
    cut = [torch.from_numpy(c.copy()) for c in jax_block[0]]
    cfg = PdwConfig.channelized(**CFG_KW)
    a = tpdw.extract_pdws_channelized_streams_cm(*cut, cfg)
    b = tpdw.extract_pdws_channelized_streams_cm(
        *cut, cfg, tmedians.median(cut[0], dim=0))
    assert int(a.count.sum()) > 4
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(a, field).numpy(),
                                      getattr(b, field).numpy(), err_msg=field)


def test_kernel_tail_without_cm_streams_flips_them_itself(jax_block):
    """It is ported: without ``cm_streams`` the tail makes them itself, by
    the flip of the time-major streams, and emits the batch of the same
    streams handed in ready-made."""
    cut, nf, entry, _, _ = jax_block
    mag, mag_cm, dph_cm, sat_cm = (torch.from_numpy(c.copy()) for c in cut)
    # a time-major phase whose wrapped steps are dph_cm's, bit for bit: on
    # a grid coarse enough for float32 sums to be exact
    dq = torch.round(dph_cm * 8.0) / 8.0
    ph = torch.cat([torch.zeros(1, M), torch.cumsum(dq.T[:-1], dim=0)])
    ph = (ph + 180.0) % 360.0 - 180.0
    kw = dict(entry_active=torch.from_numpy(entry.copy()), own_len=BLK_OWN)
    cfg = PdwConfig.channelized(**CFG_KW)
    nf_t = torch.from_numpy(nf.copy())
    got = tpdw._extract_channelized_pallas_stats(
        mag, ph, sat_cm.T.contiguous() > 0.5, cfg, nf_t, **kw)
    dq[:, -1] = 0.0
    ref = tpdw._extract_channelized_pallas_stats(
        mag, None, None, cfg, nf_t, cm_streams=(mag_cm, dq, sat_cm), **kw)
    assert int(got.count.sum()) > 4
    for field in FIELDS:
        a, b = getattr(got, field), getattr(ref, field)
        assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0)), field


@pytest.mark.parametrize("field", FIELDS)
def test_cm2_tail_with_block_contract_matches_the_cm_tail(jax_block, field):
    """The single-shot tail given ``entry_active`` / ``own_len`` emits the
    streamed tail's batch: same latch, same ranks, saturation from the
    cumulative count instead of the mask."""
    cut, nf, entry, ref, _ = jax_block
    _, mag_cm, dph_cm, sat_cm = (torch.from_numpy(c.copy()) for c in cut)
    got = tpdw._extract_channelized_cm2(
        mag_cm, dph_cm, torch.cumsum(sat_cm, 1),
        PdwConfig.channelized(**CFG_KW), torch.from_numpy(nf.copy()),
        BLK_OWN + BLK_HALO, M, entry_active=torch.from_numpy(entry.copy()),
        own_len=BLK_OWN)
    _assert_field(field, getattr(got, field).numpy(),
                  np.asarray(getattr(ref, field)))


def test_cm2_tail_latch_magnitude_keeps_an_open_pulse_open(jax_block):
    """``mag_latch_cm``: +inf over the columns past the end of a capture
    holds the latch set, so the pulse open there is not emitted, while the
    statistics of the pulses before it still read ``mag_cm``."""
    cut, nf, entry, _, _ = jax_block
    _, mag_cm, dph_cm, sat_cm = (torch.from_numpy(c.copy()) for c in cut)
    t_len = BLK_OWN + BLK_HALO

    def run(**kw):
        return tpdw._extract_channelized_cm2(
            mag_cm, dph_cm, torch.cumsum(sat_cm, 1),
            PdwConfig.channelized(**CFG_KW), torch.from_numpy(nf.copy()),
            t_len, M, entry_active=torch.from_numpy(entry.copy()),
            own_len=t_len, **kw)

    base = run()
    c = int(np.flatnonzero(entry)[0])          # the tone's channel
    n = int(base.count[c])
    last_toa = int(base.toa_idx[c][n - 1])
    latch = mag_cm.clone()
    latch[:, last_toa + 5:] = float("inf")     # the capture ends in that pulse
    got = run(mag_latch_cm=latch)
    assert n >= 2 and int(got.count[c]) == n - 1
    for field in FIELDS[:-1]:
        a, b = getattr(got, field)[c], getattr(base, field)[c]
        assert torch.equal(a[:n - 1], b[:n - 1]), field
        assert not bool(a[n - 1:].any()) or field in ("toa_idx", "te_idx")
    assert bool(torch.isfinite(got.mag).all())
