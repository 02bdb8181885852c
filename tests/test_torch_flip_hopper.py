"""The flip's Hopper forms: the one-channel streams made from a wideband
capture (``wideband_streams``, its plain version on the CPU) against the
JAX package's ``_prep_streams`` followed by ``pallas_cm_streams`` in
interpret mode, and against the port's two-step chain; a NumPy model of the
flip kernel's tile plan, its shared-memory layout and its one-channel
streaming pass (constants read from ``csrc/transpose.cu``); the wideband
entry points' routing through the fused form, strided captures included;
route ``"flat"`` handing B5's mask to the flip as it is."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.ops.pallas.transpose_kernel import pallas_cm_streams
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.models import (
    ChannelizerPipeline,
    WidebandPdwPipeline,
)
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel as tk
from torch_port_fixtures import PDW_FIELDS, packed, pulse_capture

torch.set_num_threads(1)

LEVEL = 0.75
# T of 1 and 2, and either side of a warp's span of the one-channel pass
# (256 samples: 32 lanes x 2 groups of 4) and of the JAX kernel's 1024-row
# block
LENGTHS = (1, 2, 255, 257, 1023, 1025)
CSRC = os.path.join(os.path.dirname(tk.__file__), "csrc", "transpose.cu")
N_SPECIAL = 23


def _crafted(n: int, seed: int, nan: bool = True) -> np.ndarray:
    """A complex64 capture: noise, then samples exactly at the saturation
    level and just under it, phase steps of exactly +-180 and +-360
    degrees, +-0 in both parts, +-inf and (with ``nan``) NaN."""
    rng = np.random.default_rng(seed + n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * np.float32(0.4)
    special = np.array([
        LEVEL, -LEVEL, 1j * LEVEL, -1j * LEVEL,
        np.nextafter(np.float32(LEVEL), np.float32(0)),
        1.0, -1.0, 1.0,                        # +180, then -180
        complex(-1.0, 0.0), complex(-1.0, -0.0), complex(-1.0, 0.0),  # -+360
        complex(0.0, 0.0), complex(-0.0, 0.0), complex(-0.0, -0.0),
        complex(0.0, -0.0),
        complex(np.inf, 0.0), complex(-np.inf, 1.0), complex(0.0, -np.inf),
        complex(np.inf, np.inf), complex(np.nan, 0.0), complex(0.0, np.nan),
        0.5j, -0.5,
    ], np.complex64)
    if not nan:
        special[np.isnan(special)] = 0.25 - 0.25j
    k = min(n, len(special))
    x[_start(n):_start(n) + k] = special[:k]
    return x


def _start(n: int) -> int:
    """Where ``_crafted`` puts its special samples, one after another."""
    return n // 3 if n >= 3 * N_SPECIAL else 0


def _same(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.fixture(scope="module")
def jax_streams():
    """Per length: the capture, the JAX package's detection streams and its
    flip in interpret mode, cropped to (1, T).  The capture has no NaN: the
    JAX kernel flips by a product with the identity on the MXU, so a NaN
    phase step spreads over its whole 128-column stripe there (0 x NaN);
    NaNs are held against the port's two-step chain below."""
    out = {}
    for n in LENGTHS:
        x = _crafted(n, seed=3, nan=False)
        mag, ph, sat = jpdw._prep_streams(jnp.asarray(x), LEVEL)
        flipped = pallas_cm_streams(mag[:, None], ph[:, None],
                                    sat[:, None].astype(jnp.float32),
                                    interpret=True)
        out[n] = (x, np.asarray(mag), np.asarray(ph),
                  [np.asarray(f)[:1, :n] for f in flipped])
    return out


@pytest.mark.parametrize("n", LENGTHS)
def test_wideband_streams_match_jax_prep_and_flip(jax_streams, n):
    """``sat`` exactly; ``mag`` at rtol 2e-7 (``torch.abs`` and XLA's
    ``abs`` of complex64 differ in the last place); ``dph`` exactly at every
    step whose two phases are the same bits in both packages (the flip's
    difference and wrap are exact), and within the last place of a
    difference of two phases where ``torch.angle`` and XLA's ``angle``
    differ."""
    x, jmag, jph, (_, jdph, jsat) = jax_streams[n]
    mag, dph, sat = tk.wideband_streams(torch.from_numpy(x), LEVEL)
    assert mag.shape == (n,) and dph.shape == sat.shape == (1, n)
    assert mag.dtype == dph.dtype == sat.dtype == torch.float32
    np.testing.assert_array_equal(sat.numpy(), jsat)
    np.testing.assert_allclose(mag.numpy(), jmag, rtol=2e-7, atol=0)
    _, tph, _ = tk.prep_streams(torch.from_numpy(x), LEVEL)
    tph = tph.numpy()
    agree = (tph == jph) | (np.isnan(tph) & np.isnan(jph))
    both = np.append(agree[:-1] & agree[1:], True)   # the last step is 0
    got, ref = dph.numpy()[0], jdph[0]
    np.testing.assert_array_equal(got[both], ref[both])
    np.testing.assert_allclose(got[~both], ref[~both], rtol=0, atol=1e-4)


def test_crafted_steps_are_exact_against_jax(jax_streams):
    """The crafted phase steps (multiples of 45 and 90 degrees, +-0, +-inf)
    are the same bits in both packages, wrapped the same way."""
    x, _, _, (_, jdph, _) = jax_streams[1025]
    _, dph, _ = tk.wideband_streams(torch.from_numpy(x), LEVEL)
    s0 = _start(1025)
    inside = slice(s0, s0 + N_SPECIAL - 1)   # steps between crafted samples
    np.testing.assert_array_equal(dph.numpy()[0][inside], jdph[0][inside])
    # +180 and -180 stay, +180 again, then -360 and +360 wrap to 0
    np.testing.assert_array_equal(dph.numpy()[0][s0 + 5:s0 + 10],
                                  [180.0, -180.0, 180.0, 0.0, 0.0])


@pytest.mark.parametrize("n", LENGTHS)
def test_wideband_streams_are_the_two_step_chain(n):
    """The fused form's plain version is ``prep_streams`` and the flip's
    plain version, bit for bit, NaNs included."""
    x = torch.from_numpy(_crafted(n, seed=5))
    mag, ph, sat = tk.prep_streams(x, LEVEL)
    chain = tk.cm_streams_plain(mag[:, None], ph[:, None], sat[:, None])
    got = tk.wideband_streams(x, LEVEL)
    assert _same(got[0], mag) and _same(got[0][None], chain[0])
    assert _same(got[1], chain[1]) and _same(got[2], chain[2])


def test_pdw_prep_is_the_kernels_plain_front():
    """``dsp.pdw``'s detection streams are the fused form's plain front."""
    assert tpdw._prep_streams is tk.prep_streams
    assert tpdw._RAD2DEG == tk.RAD2DEG == float(np.float32(180.0 / np.pi))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(8, dtype=torch.complex64)
    with pytest.raises(TypeError):
        tk.wideband_streams(x.to(torch.complex128), LEVEL)
    with pytest.raises(TypeError):
        tk.wideband_streams(x.reshape(2, 4), LEVEL)
    with pytest.raises(TypeError):
        tk.wideband_streams(x.real, LEVEL)


def test_stage_tables_hold_the_fused_form():
    assert kernels.KERNELS.wideband_streams is tk.wideband_streams
    assert kernels.PLAIN.wideband_streams is tk.wideband_streams_plain
    assert tk.launches_wideband == 0   # nothing here runs on a card


# ---------------------------------------------------------------- the model

def _consts() -> dict:
    src = open(CSRC).read()

    def get(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    k = dict(threads=get("kThreads"), tf=get("kTileFrames"),
             tc=get("kTileChannels"), gpl=get("kGroupsPerLane"))
    # the kernel's index arithmetic is written with these as shifts
    assert (k["threads"], k["tc"]) == (256, 32) and k["tf"] % 32 == 0
    return k


def _swz(t, c, tc=32):
    chunks = tc // 4
    return t * tc + ((((c >> 2) ^ (t >> 2)) & (chunks - 1)) << 2) + (c & 3)


def _flip_model(m: int, t_len: int, vec: bool, bool_sat: bool, k: dict):
    """The flip kernel's tile plan at M >= 2, tile by tile: what each copy
    writes into a stage and what each store reads back.  Labels are the
    flat (t, c) index of the sample a slot holds.  Returns how often each
    output (c, t) was written; asserts the reads and the banks."""
    tf, tc, nthr = k["tf"], k["tc"], k["threads"]
    chunks, ph_rows = tc // 4, tf + 1
    n_ct = -(-m // tc)
    n_tiles = -(-t_len // tf) * n_ct
    written = np.zeros((m, t_len), np.int64)
    for tile in range(n_tiles):
        tt, ct = divmod(tile, n_ct)
        c0, t0 = ct * tc, tt * tf
        nt, nph, nc = min(tf, t_len - t0), min(ph_rows, t_len - t0), \
            min(tc, m - c0)
        s_ph = np.full(ph_rows * tc, -1, np.int64)
        s_mag = np.full(tf * tc, -1, np.int64)
        s_sat = np.full(tf * tc, -1, np.int64)
        if vec:
            p = np.arange(ph_rows * chunks)
            t, c = p >> 3, (p & (chunks - 1)) << 2
            ok = (t < nph) & (c < nc)
            # a quarter warp's eight 16-byte copies land on eight chunks
            for q in range(0, len(p), 8):
                rows = ok[q:q + 8]
                if rows.all():
                    banks = _swz(t[q:q + 8], c[q:q + 8]) // 4 % 8
                    assert len(set(banks)) == 8
            for i in range(4):
                ti, ci = t[ok], c[ok] + i
                slot = _swz(ti, ci)
                lab = (t0 + ti) * m + c0 + ci
                assert (s_ph[slot] == -1).all()
                s_ph[slot] = lab
                row = ti < nt
                s_mag[slot[row]] = lab[row]
                s_sat[slot[row]] = lab[row]
        else:
            e = np.arange(ph_rows * tc)
            t, c = e >> 5, e & (tc - 1)
            ok = (t < nph) & (c < nc)
            slot, lab = _swz(t[ok], c[ok]), (t0 + t[ok]) * m + c0 + c[ok]
            assert (s_ph[slot] == -1).all()
            s_ph[slot] = lab
            row = t[ok] < nt
            s_mag[slot[row]] = lab[row]
            if bool_sat:   # through registers: every slot, 0 off the tile
                e = np.arange(tf * tc // nthr)[:, None] * nthr + \
                    np.arange(nthr)[None, :]
                t, c = (e >> 5).ravel(), (e & 31).ravel()
                inside = (t < nt) & (c < nc)
                s_sat[_swz(t, c)] = np.where(inside, (t0 + t) * m + c0 + c,
                                             -2)
            else:
                s_sat[slot[row]] = lab[row]
        # the store: group q is channel q / 8 % 32, frames 4 (q % 8 + 8 (q /
        # 256)) .. + 3
        q = np.arange(tf * tc // 4)
        c = (q >> 3) & (tc - 1)
        tb = ((q & 7) | ((q >> 8) << 3)) << 2
        for j in range(5):   # a warp's reads of one frame: 32 banks
            for w in range(0, len(q), 32):
                banks = _swz(tb[w:w + 32] + j, c[w:w + 32]) % 32
                assert len(set(banks)) == 32
                words = set(_swz(tb[w:w + 32] + j, c[w:w + 32]) // 4)
                assert len({x % 32 for x in words}) == len(words)
        live = (c < nc) & (tb < nt)
        for j in range(4):
            tj = tb + j
            out = live & (tj < nt)
            cc, tt_ = c[out], tj[out]
            np.add.at(written, (c0 + cc, t0 + tt_), 1)
            want = (t0 + tt_) * m + c0 + cc
            assert (s_mag[_swz(tt_, cc)] == want).all()
            assert (s_sat[_swz(tt_, cc)] == want).all()
            assert (s_ph[_swz(tt_, cc)] == want).all()
            # the look-ahead: frame t + 1 of the same channel, where it
            # counts (the step from T - 1 on is zero)
            ahead = t0 + tt_ < t_len - 1
            assert (s_ph[_swz(tt_[ahead] + 1, cc[ahead])]
                    == want[ahead] + m).all()
    return written


def _stream_model(t_len: int, v: int, k: dict):
    """The one-channel pass: warps walk spans of 32 lanes x ``gpl`` groups
    of ``v`` samples; a group's look-ahead is the next lane's first sample,
    or a load at the warp's last lane.  Returns how often each sample was
    written and the index each step's look-ahead read."""
    gpl = k["gpl"]
    n_groups = -(-t_len // v)
    written = np.zeros(t_len, np.int64)
    ahead = np.full(t_len, -1, np.int64)
    span = 32 * gpl
    for base in range(0, n_groups, span):
        for u in range(gpl):
            g = base + u * 32 + np.arange(32)
            t = g * v
            first = t                                  # v[u][0] of each lane
            nxt = np.append(first[1:], -1)             # the shuffle down
            nxt[31] = t[31] + v                        # the last lane's load
            for lane in range(32):
                if t[lane] >= t_len:
                    continue
                for i in range(v):
                    ti = t[lane] + i
                    if ti >= t_len:
                        break
                    written[ti] += 1
                    ahead[ti] = ti + 1 if i + 1 < v else nxt[lane]
    return written, ahead


MODEL_M = (1, 2, 3, 31, 32, 33, 64, 65, 560)


@pytest.mark.parametrize("m", MODEL_M)
def test_model_writes_every_sample_once_and_looks_one_frame_ahead(m):
    k = _consts()
    tf = k["tf"]
    span = 32 * k["gpl"] * 4
    lengths = sorted({1, 2, tf - 1, tf, tf + 1, 2 * tf - 1, 2 * tf + 1,
                      span - 1, span, span + 1})
    for t_len in lengths:
        if m == 1:
            for v in (4, 1):
                written, ahead = _stream_model(t_len, v, k)
                assert (written == 1).all(), (t_len, v)
                live = np.arange(t_len - 1)
                assert (ahead[live] == live + 1).all(), (t_len, v)
            continue
        variants = [(False, b) for b in (False, True)]
        if m % 4 == 0:
            variants += [(True, b) for b in (False, True)]
        for vec, bool_sat in variants:
            written = _flip_model(m, t_len, vec, bool_sat, k)
            assert (written == 1).all(), (m, t_len, vec, bool_sat)


# ----------------------------------------------------- the routes through it

def _wideband_capture(n=6000, seed=11):
    rng = np.random.default_rng(seed)
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 2e-3
         ).astype(np.complex64)
    for s in (500, 2100, 4300):
        x[s:s + 300] = np.exp(1j * 0.3 * np.arange(300)) * 0.5
    x[2200:2240] = 1.0 + 0.1j   # a saturated stretch
    return torch.from_numpy(x)


class _Spy:
    """A stage table whose ``name`` stage records the calls it gets."""

    def __init__(self, base, *names):
        self.calls = {n: [] for n in names}

        def wrap(n):
            fn = getattr(base, n)

            def call(*a, **kw):
                self.calls[n].append(a)
                return fn(*a, **kw)
            return call
        self.ops = dataclasses.replace(base, **{n: wrap(n) for n in names})


@pytest.mark.parametrize("planes", [False, True], ids=["complex", "planes"])
def test_single_shot_kernel_tail_takes_the_fused_form(planes):
    """``extract_pdws`` with the kernel tail (``stats="pallas"``, here the
    plain versions) makes its streams with ``wideband_streams`` and no
    flip, and gives the batch of the two-step streams bit for bit; the
    oracle tail and the blocked tail keep the two-step prep.  The planes
    entry keeps its own prep and the flip."""
    cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=512)
    x = _wideband_capture()
    spy = _Spy(kernels.PLAIN, "wideband_streams", "cm_streams")
    if planes:
        yr, yi = x.real.contiguous(), x.imag.contiguous()
        got = tpdw.extract_pdws_planes(yr, yi, cfg, stats="pallas",
                                       ops=spy.ops)
        mag, ph, sat = tpdw._prep_streams_planes(yr, yi, cfg.saturation_level)
        assert not spy.calls["wideband_streams"]
        assert len(spy.calls["cm_streams"]) == 1
    else:
        got = tpdw.extract_pdws(x, cfg, stats="pallas", ops=spy.ops)
        mag, ph, sat = tk.prep_streams(x, cfg.saturation_level)
        assert len(spy.calls["wideband_streams"]) == 1
        assert not spy.calls["cm_streams"]
    nf = tpdw.noise_floor_1d(mag, ops=kernels.PLAIN)
    ref = tpdw._extract_wideband_from_streams(mag, ph, sat, cfg, nf,
                                              stats="pallas",
                                              ops=kernels.PLAIN)
    assert int(ref.count) == 3
    for field in PDW_FIELDS:
        assert _same(getattr(got, field), getattr(ref, field)), field
    for stats in ("xla", "blocked"):
        spy.calls["wideband_streams"].clear()
        if planes:
            tpdw.extract_pdws_planes(yr, yi, cfg, stats=stats, ops=spy.ops)
        else:
            tpdw.extract_pdws(x, cfg, stats=stats, ops=spy.ops)
        assert not spy.calls["wideband_streams"], stats


@pytest.mark.parametrize("planes", [False, True], ids=["complex", "planes"])
def test_strided_captures_take_the_kernel_tail(planes):
    """A capture that is a strided view (every other sample of a longer
    one; the planes ``x.real`` / ``x.imag`` with a stride of two floats)
    gives the PDWs of its contiguous copy on the kernel tail; the fused
    form is handed a contiguous capture, as its kernel requires."""
    cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=512)
    wide = _wideband_capture(n=12000)
    spy = _Spy(kernels.PLAIN, "wideband_streams", "cm_streams")
    if planes:
        x = _wideband_capture()
        assert x.real.stride() == (2,)
        got = tpdw.extract_pdws_planes(x.real, x.imag, cfg, stats="pallas",
                                       ops=spy.ops)
        ref = tpdw.extract_pdws_planes(x.real.contiguous(),
                                       x.imag.contiguous(), cfg,
                                       stats="pallas", ops=kernels.PLAIN)
        (call,) = spy.calls["cm_streams"]
    else:
        x = wide[::2]
        assert not x.is_contiguous()
        got = tpdw.extract_pdws(x, cfg, stats="pallas", ops=spy.ops)
        ref = tpdw.extract_pdws(x.contiguous(), cfg, stats="pallas",
                                ops=kernels.PLAIN)
        (call,) = spy.calls["wideband_streams"]
    assert all(a.is_contiguous() for a in call if torch.is_tensor(a))
    assert int(ref.count) >= 1
    for field in PDW_FIELDS:
        assert _same(getattr(got, field), getattr(ref, field)), field


def test_wideband_tail_routing_by_length():
    cpu, n = torch.zeros(1), tpdw._WIDEBAND_BLOCKED_FROM
    assert n == 1 << 24
    assert tpdw._wideband_tail("pallas", cpu, n - 1) == "pallas"
    assert tpdw._wideband_tail("pallas", cpu, n) == "blocked"
    assert tpdw._wideband_tail("auto", cpu, 10) == "auto"   # the oracle
    assert tpdw._wideband_tail("xla", cpu, 10) == "xla"
    assert tpdw._wideband_tail("blocked", cpu, 10) == "blocked"


def test_pipeline_forward_returns_the_fused_floor():
    """``WidebandPdwPipeline.forward`` is ``extract_pdws_with_floor``: the
    floor is K2's (here its plain version) on the fused magnitude."""
    cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=512)
    x = _wideband_capture()
    pipe = WidebandPdwPipeline(cfg, device="cpu")
    nf, batch = pipe.forward(x)
    nf2, batch2 = tpdw.extract_pdws_with_floor(x, cfg)
    assert torch.equal(nf, nf2) and int(batch.count) == 3
    for field in PDW_FIELDS:
        assert _same(getattr(batch, field), getattr(batch2, field)), field
    mag = tk.prep_streams(x, cfg.saturation_level)[0]
    nf3, batch3 = tpdw.extract_pdws_with_floor(x, cfg, stats="pallas")
    assert torch.equal(nf3, tpdw.noise_floor_1d(mag, ops=kernels.PLAIN))
    assert torch.equal(nf3, nf) and torch.equal(batch3.toa_idx,
                                                 batch.toa_idx)


def test_flat_route_hands_b5s_mask_to_the_flip_as_it_is():
    """Route ``"flat"`` gives the flip the 0/1 float mask B5 wrote, not a
    bool made from it: the same ``sat_cm`` and the same PDWs."""
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=256)
    pipe = ChannelizerPipeline.create(8, pdw_cfg=cfg, device="cpu")
    xq = torch.from_numpy(packed(pulse_capture(12)))
    spy = _Spy(kernels.PLAIN, "cm_streams")
    streams = kernels.PLAIN.channelize_flat(
        xq, pipe.channelizer.taps_rev, bit_width=12,
        sat_level=cfg.saturation_level)
    nf, mag, batch = pipe._fused_tail("flat", lambda _: streams, spy.ops)
    (call,) = spy.calls["cm_streams"]
    assert call[2].dtype == torch.float32 and call[2] is streams[2]
    assert float(streams[2].sum()) > 0   # the clipped stretch
    as_bool = tk.cm_streams_plain(streams[0], streams[1], streams[2] > 0.5)
    as_is = tk.cm_streams_plain(*streams)
    assert all(torch.equal(a, b) for a, b in zip(as_bool, as_is))
    ref = pipe.forward_packed(xq, 12, route="flat", plain=True)[2]
    for field in PDW_FIELDS:
        assert _same(getattr(batch, field), getattr(ref, field)), field
