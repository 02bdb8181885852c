"""The port's fused sharded routes and the channelizer's band slice.

* The band slice (``w_parts``): the plain versions of the channelizer
  kernel's cm2 form (K1) and flat form (B5) with a column slice of the DFT
  matrix against the JAX package's Pallas kernels with the same slice, run
  in interpret mode once each in a module-scoped fixture; and each band of a
  slice against the full matrix's band, bit for bit.
* The sharded ``step_packed`` / ``step_fused`` on routes ``"cm2"`` and
  ``"cm"`` (the kernels' plain versions on the CPU), against the port's own
  single-device ``forward_packed`` (the invariant: integer fields and
  ``mag`` exact, freq / snr within rtol 1e-9, atol 1e-5, the bars of
  ``test_parallel_fused.py``) and against the JAX package's oracle
  ``ChannelizerPipeline.extract`` of the same capture (the interpret-mode
  JAX sharded cm2 route is too slow to be the oracle here).
* The route choice: cm2 at m_loc = 10 (no 8-row condition), indivisible
  bands refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.dsp.channelizer import dft_matrix as jdft_matrix
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import (
    ChannelizerPipeline as JPipeline,
)
from sdr_channelizer_tpu.ops.pallas.channelizer_kernel import (
    pallas_channelize_streams_packed,
    pallas_channelize_streams_packed_cm2,
)
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
from sdr_channelizer_tpu_torch.models import ChannelizerPipeline
from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh
from sdr_channelizer_tpu_torch.parallel.pipeline import merge_block_batches
from torch_port_fixtures import packed, pulse_capture

torch.set_num_threads(1)

CFG = PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)
SLICES = {16: [(0, 8), (8, 8)], 20: [(0, 10), (10, 10)]}


def _samples(m, bit_width=12, n_frames=1024, seed=3) -> np.ndarray:
    """The two-emitter capture of ``test_parallel_fused.py`` at M = m, as
    an (N, 2) integer payload, with a strong pulse re-opened at the
    capture's end (it must not be emitted)."""
    n = n_frames * m
    fs = m * 1e6
    dur = n / fs
    specs = [
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=1.02e6, pulse_width_sec=40e-6,
                       pri_sec=110e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=-2.97e6, pulse_width_sec=80e-6,
                       pri_sec=270e-6, start_index=803),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = (iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    iq[-60:] = iq[37:37 + 60]
    return np.ascontiguousarray(iqpacket.from_complex(iq, bit_width)[:n])


def _w_parts(m, c0, n):
    w = jdft_matrix(m, shifted=True)
    return (np.ascontiguousarray(np.real(w)[:, c0:c0 + n], np.float32),
            np.ascontiguousarray(np.imag(w)[:, c0:c0 + n], np.float32))


# ---------------------------------------------------------- band slices

@pytest.fixture(scope="module")
def sliced_jax():
    """The JAX kernels with each slice, in interpret mode, once."""
    out = {}
    for m, slices in SLICES.items():
        taps = np.asarray(JChannelizer.create(m).taps_rev)
        xq = jnp.asarray(packed(pulse_capture(12, m=m)))
        for c0, n in slices:
            wp = _w_parts(m, c0, n)
            cm2 = pallas_channelize_streams_packed_cm2(
                xq, taps, bit_width=12, w_parts=wp, interpret=True)
            flat = pallas_channelize_streams_packed(
                xq, taps, bit_width=12, w_parts=wp, interpret=True)
            out[(m, c0)] = ([np.asarray(a) for a in cm2],
                            [np.asarray(a) for a in flat])
    return out


@pytest.mark.parametrize("m,c0", [(m, c0) for m, sl in SLICES.items()
                                  for c0, _ in sl])
def test_k1_band_slice_matches_the_jax_kernel(sliced_jax, m, c0):
    n = dict(SLICES[m])[c0]
    samples = pulse_capture(12, m=m)
    xq = torch.from_numpy(packed(samples))
    taps = Channelizer.create(m).taps_rev
    got = ck.channelize_streams_packed_cm2_plain(
        xq, taps, 12, w_parts=_w_parts(m, c0, n))
    ref = sliced_jax[(m, c0)][0]
    t_len = len(xq) // m
    assert all(g.shape == (n, t_len) for g in got)
    r_mag = ref[0][:n, :t_len]
    np.testing.assert_allclose(got[0].numpy(), r_mag, rtol=1e-5, atol=1e-5)
    # the phase difference at the bar of ``test_torch_channelizer_kernel``:
    # modulo 360, where both frames carry a phase
    d = (got[1].numpy() - ref[1][:n, :t_len] + 180.0) % 360.0 - 180.0
    loud = r_mag > 1e-4
    loud[:, :-1] &= loud[:, 1:]
    assert np.abs(d[loud]).max() <= 0.05
    assert not got[1][:, -1].any()
    np.testing.assert_array_equal(got[2].numpy(), ref[2][:n, :t_len])
    # the clipped segment is counted (in some of the bands)
    assert ck.channelize_streams_packed_cm2_plain(xq, taps, 12)[2].max() > 0


@pytest.mark.parametrize("m,c0", [(m, c0) for m, sl in SLICES.items()
                                  for c0, _ in sl])
def test_b5_band_slice_matches_the_jax_kernel(sliced_jax, m, c0):
    n = dict(SLICES[m])[c0]
    xq = torch.from_numpy(packed(pulse_capture(12, m=m)))
    taps = Channelizer.create(m).taps_rev
    mag, ph, sat = ck.channelize_streams_packed_plain(
        xq, taps, 12, w_parts=_w_parts(m, c0, n))
    r_mag, r_ph, r_sat = sliced_jax[(m, c0)][1]
    np.testing.assert_allclose(mag.numpy(), r_mag, rtol=1e-5, atol=1e-5)
    # degrees: the bar where |y| carries a phase
    loud = r_mag > 1e-2
    d = (ph.numpy() - r_ph + 180.0) % 360.0 - 180.0
    assert float(np.abs(d[loud]).max()) < 1e-3
    np.testing.assert_array_equal(sat.numpy(), r_sat)


@pytest.mark.parametrize("m,c0,n", [(16, 0, 8), (16, 8, 8), (20, 10, 10),
                                    (20, 3, 7), (64, 5, 13)])
def test_band_slice_is_the_full_matrix_band(m, c0, n):
    """Plain versions on the CPU: a slice's bands are the full matrix's, bit
    for bit, in both forms and both ingests, with a history too."""
    samples = pulse_capture(12, m=m)
    xq = torch.from_numpy(packed(samples))
    taps = Channelizer.create(m).taps_rev
    wp = _w_parts(m, c0, n)
    cols = slice(c0, c0 + n)
    full = ck.channelize_streams_packed_cm2(xq, taps, 12)
    part = ck.channelize_streams_packed_cm2(xq, taps, 12, w_parts=wp)
    assert all(torch.equal(a[cols], b) for a, b in zip(full, part))
    flat = ck.channelize_streams_packed(xq, taps, 12)
    pflat = ck.channelize_streams_packed(xq, taps, 12, w_parts=wp)
    assert all(torch.equal(a[:, cols], b) for a, b in zip(flat, pflat))
    xr = torch.from_numpy(np.ascontiguousarray(samples[:, 0]))
    xi = torch.from_numpy(np.ascontiguousarray(samples[:, 1]))
    p = taps.shape[0]
    hist = (xr[:(p - 1) * m].contiguous(), xi[:(p - 1) * m].contiguous())
    tail = (xr[(p - 1) * m:].contiguous(), xi[(p - 1) * m:].contiguous())
    a = ck.channelize_streams_cm2(*tail, taps, 12, history=hist)
    b = ck.channelize_streams_cm2(*tail, taps, 12, history=hist, w_parts=wp)
    assert all(torch.equal(x[cols], y) for x, y in zip(a, b))
    a = ck.channelize_streams(*tail, taps, 12, history=hist)
    b = ck.channelize_streams(*tail, taps, 12, history=hist, w_parts=wp)
    assert all(torch.equal(x[:, cols], y) for x, y in zip(a, b))


def test_fragments_of_a_slice_are_the_full_matrix_tiles():
    """The kernel's B fragments of a slice starting on an n-tile boundary
    are the full matrix's tiles (the same split, the same k-steps); a
    refused slice shape raises."""
    m = 64
    full = ck.dft_fragments(m)
    for c0, n in ((0, 32), (32, 32), (8, 24)):
        part = ck.dft_fragments(m, w_parts=ck.band_slice(
            _w_parts(m, c0, n), m))
        assert part.shape == (n // 8, m // 8, 32, 8)
        np.testing.assert_array_equal(part, full[c0 // 8:(c0 + n) // 8])
    odd = ck.dft_fragments(20, w_parts=ck.band_slice(_w_parts(20, 3, 7), 20))
    assert odd.shape == (1, 3, 32, 8)
    with pytest.raises(ValueError, match="w_parts"):
        ck.band_slice(_w_parts(16, 0, 8), 20)


# ------------------------------------------------------- fused routes

def _pdws(pipe, batch, t_loc, fs):
    return pipe._finalize_merged(batch, t_loc, fs, 1e9, 2.0)


def _assert_pdws_equal(got, ref):
    """The invariant's bars (``test_parallel_fused.py``)."""
    order_g = np.lexsort((got["channel"], got["toa"]))
    order_r = np.lexsort((ref["channel"], ref["toa"]))
    got = {k: np.asarray(v)[order_g] for k, v in got.items()}
    ref = {k: np.asarray(v)[order_r] for k, v in ref.items()}
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "pw", "mag", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("freq", "snr"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=1e-5)


def _assert_pdws_close(got, ref):
    """The bars between the port and the JAX CPU oracle
    (``test_torch_pipeline.py``)."""
    order_g = np.lexsort((got["channel"], got["toa"]))
    order_r = np.lexsort((ref["channel"], ref["toa"]))
    got = {k: np.asarray(v)[order_g] for k, v in got.items()}
    ref = {k: np.asarray(v)[order_r] for k, v in ref.items()}
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("channel", "sat"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["toa"], ref["toa"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=1e-6)
    np.testing.assert_allclose(got["snr"], ref["snr"], atol=1e-3)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    ok = ~(np.isnan(got["freq"]) & np.isnan(ref["freq"]))
    np.testing.assert_allclose(got["freq"][ok], ref["freq"][ok], atol=50.0)


@pytest.fixture(scope="module")
def jax_oracle():
    """The JAX CPU oracle's PDWs of each capture, once."""
    out = {}
    for m in (8, 16):
        samples = _samples(m)
        jpipe = JPipeline.create(m, pdw_cfg=CFG)
        out[m] = jpipe.extract(jnp.asarray(iqpacket.to_complex(samples, 12)),
                               fs=m * 1e6, fc=1e9, sample_start_time=2.0)
    return out


def _single(m):
    return ChannelizerPipeline(Channelizer.create(m), CFG, "cpu")


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("route", ["cm2", "cm"])
def test_step_packed_is_the_single_device_step(jax_oracle, mesh_shape,
                                               route):
    n_time, n_chan = mesh_shape
    m = 16 if n_chan > 1 else 8
    fs = m * 1e6
    samples = _samples(m)
    xq = packed(samples)
    single = _single(m)
    # route cm's tail is the kernel tail ("pallas"), as the single-device
    # flat route's
    nf_r, _, ref = single.forward_packed(
        xq, 12, route="cm2" if route == "cm2" else "flat")
    pipe = ShardedPipeline(make_mesh(n_time, n_chan, devices=["cpu"] * 4),
                           single.channelizer, CFG)
    nf, got = pipe.step_packed(xq, 12, route=route,
                               stats="auto" if route == "cm2" else "pallas")
    np.testing.assert_array_equal(nf.numpy(), nf_r.numpy())
    t_loc = len(xq) // (n_time * m)
    got_d = _pdws(pipe, got, t_loc, fs)
    _assert_pdws_equal(got_d, single._finalize(ref, fs, 1e9, 2.0))
    _assert_pdws_close(got_d, jax_oracle[m])


def test_route_cm_oracle_tail_is_its_kernel_tail():
    samples = _samples(16)
    pipe = ShardedPipeline(make_mesh(2, 2, devices=["cpu"] * 4),
                           Channelizer.create(16), CFG)
    xq = packed(samples)
    _, a = pipe.step_packed(xq, 12, route="cm", stats="pallas")
    _, b = pipe.step_packed(xq, 12, route="cm", stats="xla")
    for f in ("toa_idx", "te_idx", "pw_sec", "mag", "saturated", "valid",
              "count"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
    np.testing.assert_allclose(a.snr_db.numpy(), b.snr_db.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="stats"):
        pipe.step_packed(xq, 12, route="cm", stats="fast")
    with pytest.raises(ValueError, match="route"):
        pipe.step_packed(xq, 12, route="flat")


@pytest.mark.parametrize("bit_width", [8, 12])
def test_extract_fused_payloads(bit_width):
    """int8 pairs go packed as int16, int16 pairs as int32, float payloads
    as two planes: the same PDWs as the single-device main path."""
    m = 8
    samples = _samples(m, bit_width=bit_width)
    single = _single(m)
    pipe = ShardedPipeline(make_mesh(4, 1, devices=["cpu"] * 4),
                           single.channelizer, CFG)
    kw = dict(fs=m * 1e6, fc=1e9, sample_start_time=2.0)
    _assert_pdws_equal(pipe.extract_fused(samples, bit_width, **kw),
                       single.extract_fused(samples, bit_width, **kw))
    floats = (samples.astype(np.float32) / 2.0 ** (bit_width - 1))
    _assert_pdws_equal(pipe.extract_fused(floats, 0, **kw),
                       single.extract_fused(floats, 0, **kw))


@pytest.mark.parametrize("planes", ["float32", "int16"])
@pytest.mark.parametrize("route", ["cm2", "cm"])
def test_planes_routes_match_the_single_device_step(planes, route):
    """Two sample planes (float32, or int16 with the bit width) through the
    sharded step_fused, each route against the single-device step's."""
    m = 16
    samples = _samples(m)
    single = _single(m)
    if planes == "float32":
        xr = np.ascontiguousarray(samples[:, 0], np.float32) / 2048.0
        xi = np.ascontiguousarray(samples[:, 1], np.float32) / 2048.0
        bw = 0
    else:
        xr = np.ascontiguousarray(samples[:, 0])
        xi = np.ascontiguousarray(samples[:, 1])
        bw = 12
    nf_r, _, ref = single.forward_fused(
        xr, xi, bit_width=bw, route="cm2" if route == "cm2" else "flat")
    pipe = ShardedPipeline(make_mesh(2, 2, devices=["cpu"] * 4),
                           single.channelizer, CFG)
    nf, got = pipe.step_fused(xr, xi, bit_width=bw, route=route,
                              stats="auto" if route == "cm2" else "pallas")
    np.testing.assert_array_equal(nf.numpy(), nf_r.numpy())
    merged = merge_block_batches(got, len(xr) // (2 * m))
    _assert_pdws_equal(
        pdwmod.finalize_pdws(merged, fs=1e6, fc=1e9, sample_start_time=2.0,
                             bin_offsets_hz=single.channelizer
                             .center_frequencies(m * 1e6)),
        single._finalize(ref, m * 1e6, 1e9, 2.0))


def test_cm2_is_taken_at_ten_bands_a_shard():
    """The JAX package asks 8-row band slices of cm2 (its TPU layout); the
    port does not: at M = 20 over two mesh columns cm2 is taken, K1 runs
    with a slice that starts off a multiple of 8, and the PDWs are the
    single-device step's."""
    m = 20
    samples = _samples(m)
    xq = packed(samples)
    single = _single(m)
    pipe = ShardedPipeline(make_mesh(2, 2, devices=["cpu"] * 4),
                           single.channelizer, CFG)
    assert pipe._fused2_ok(len(xq))
    assert pipe._w_slice(1)[0].shape == (m, 10)
    before = ck.launches
    nf, got = pipe.step_packed(xq, 12)   # route "auto"
    assert ck.launches == before  # plain versions on the CPU, no kernel
    _, _, ref = single.forward_packed(xq, 12)
    _assert_pdws_equal(_pdws(pipe, got, len(xq) // (2 * m), m * 1e6),
                       single._finalize(ref, m * 1e6, 1e9, 2.0))


def test_route_choice_and_refusals():
    chan = Channelizer.create(8)
    mesh = make_mesh(2, 3, devices=["cpu"] * 6)
    pipe = ShardedPipeline(mesh, chan, CFG)
    with pytest.raises(ValueError, match="divisible"):
        pipe.step_packed(np.zeros(4096, np.int32), bit_width=12)
    assert not pipe._fused2_ok(4096)
    few = ShardedPipeline(make_mesh(8, 1, devices=["cpu"] * 8), chan, CFG)
    # 8 frames a shard: fewer than the P - 1 frames of FIR history
    assert not few._fused2_ok(8 * 8 * 8)
    with pytest.raises(ValueError, match="P-1"):
        few.step_packed(np.zeros(8 * 8 * 8, np.int32), 12, route="cm2")
    strict = ShardedPipeline(make_mesh(4, 1, devices=["cpu"] * 4), chan,
                             dataclasses.replace(CFG, max_pulse_samples=4096),
                             halo_mode="strict")
    with pytest.raises(ValueError, match="halo"):
        strict.step_packed(packed(_samples(8)), 12)


def test_slots_are_per_shard():
    """``max_pulses`` bounds a channel's pulses in each time shard (the JAX
    package's layout: the merged batch has ``n_time * max_pulses`` slots a
    channel): where a channel fills its slots the sharded step emits more
    than the single-device one, and its first ``max_pulses`` a channel by
    TOA are the single-device step's."""
    m = 8
    cfg = dataclasses.replace(CFG, max_pulses=2)
    samples = _samples(m)
    single = ChannelizerPipeline(Channelizer.create(m), cfg, "cpu")
    ref = single.extract_fused(samples, 12, fs=m * 1e6)
    pipe = ShardedPipeline(make_mesh(4, 1, devices=["cpu"] * 4),
                           single.channelizer, cfg)
    got = pipe.extract_fused(samples, 12, fs=m * 1e6)
    full = np.bincount(ref["channel"], minlength=m)
    assert (full == 2).sum() >= 2 and len(got["toa"]) > len(ref["toa"])
    keep = np.zeros(len(got["toa"]), bool)
    for c in range(m):
        idx = np.nonzero(got["channel"] == c)[0]
        assert len(idx) <= 4 * cfg.max_pulses
        keep[idx[np.argsort(got["toa"][idx], kind="stable")[:2]]] = True
    _assert_pdws_equal({k: v[keep] for k, v in got.items()}, ref)
