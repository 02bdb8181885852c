"""The port's channelizer (the plain versions of kernel K1, of its cm, flat
and complex forms and of their planes ingests, and the FFT oracle) against
the JAX package on the same inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.dsp import channelizer as jchan
from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu.ops.pallas.channelizer_kernel import (
    pallas_channelize,
    pallas_channelize_streams,
    pallas_channelize_streams_packed,
    pallas_channelize_streams_packed_cm,
    pallas_channelize_streams_packed_cm2,
)
from sdr_channelizer_tpu_torch.dsp import channelizer as tchan
from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
from torch_port_fixtures import M, packed, pulse_capture

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[12, 8], ids=["int16", "int8"])
def streams(request):
    """(JAX streams cut to the real rows and columns, the port's, t_len)."""
    bw = request.param
    xq = packed(pulse_capture(bw))
    taps = jchan.Channelizer.create(M).taps_rev
    ref = pallas_channelize_streams_packed_cm2(
        jnp.asarray(xq), taps, bit_width=bw, block_frames=256, interpret=True)
    t_len = len(xq) // M
    ref = [np.asarray(r) for r in ref]
    assert not ref[0][:, t_len:].any() and not ref[1][:, t_len:].any()
    got = ck.channelize_streams_packed_cm2(torch.from_numpy(xq), taps, bw)
    return ([r[:M, :t_len] for r in ref], [g.numpy() for g in got], t_len)


def test_stream_shapes(streams):
    ref, got, t_len = streams
    for g in got:
        assert g.shape == (M, t_len) and g.dtype == np.float32


def test_mag_cm_matches_jax_kernel(streams):
    ref, got, _ = streams
    # the DFT sums in another order: the JAX package's own bar
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)


def test_dph_cm_matches_jax_kernel(streams):
    ref, got, t_len = streams
    d = (got[1] - ref[1] + 180.0) % 360.0 - 180.0
    loud = ref[0] > 1e-4
    loud[:, :-1] &= loud[:, 1:]
    assert np.abs(d[loud]).max() <= 0.05
    assert not got[1][:, t_len - 1:].any()  # zero from column t_len - 1 on
    assert np.abs(got[1]).max() <= 180.0


def test_satcs_cm_matches_jax_kernel_exactly(streams):
    ref, got, _ = streams
    assert ref[2].max() > 0  # the clipped segment saturates
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("m", [8, 20, 56, 64])
def test_taps_equal_jax_package(m):
    np.testing.assert_array_equal(tchan.Channelizer.create(m).taps_rev,
                                  jchan.Channelizer.create(m).taps_rev)
    np.testing.assert_array_equal(tchan.dft_matrix(m), jchan.dft_matrix(m))
    np.testing.assert_array_equal(tchan.center_frequencies(m, 1e6 * m),
                                  jchan.center_frequencies(m, 1e6 * m))


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_channelize_matches_jax(method):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(8 * 500) + 1j * rng.standard_normal(8 * 500)
         ).astype(np.complex64)
    ref = np.asarray(jchan.channelize(jnp.asarray(x),
                                      jchan.Channelizer.create(M),
                                      method=method))
    got = tchan.channelize(x, tchan.Channelizer.create(M), method=method,
                           device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("m,frames,bw", [(20, 777, 12), (56, 131, 8)])
def test_plain_kernel_matches_port_channelize(m, frames, bw):
    """M that is no power of two, T that is a multiple of nothing."""
    rng = np.random.default_rng(m)
    full = 1 << (bw - 1)
    dt = np.int8 if bw == 8 else np.int16
    s = rng.integers(-full // 2, full // 2, size=(m * frames + 3, 2)).astype(dt)
    s[40 * m:42 * m] = full - 1
    chan = tchan.Channelizer.create(m)
    mag, dph, satcs = ck.channelize_streams_packed_cm2(
        torch.from_numpy(packed(s)), chan.taps_rev, bw)
    iq = (s[:, 0].astype(np.float32) + 1j * s[:, 1].astype(np.float32)) / full
    y = tchan.channelize(iq.astype(np.complex64), chan, device="cpu")
    assert mag.shape == (m, frames)
    np.testing.assert_allclose(mag.numpy(), y.abs().T.numpy(),
                               rtol=1e-5, atol=1e-5)
    ph = torch.angle(y) * (180.0 / np.pi)
    want = (ph[1:] - ph[:-1]).T.numpy()
    d = (dph[:, :-1].numpy() - want + 180.0) % 360.0 - 180.0
    assert np.abs(d[(y.abs().T.numpy() > 1e-4)[:, :-1]]).max() <= 0.05
    sat = ((y.real.abs() >= 0.9999) | (y.imag.abs() >= 0.9999)).T.numpy()
    assert sat.any()
    np.testing.assert_array_equal(satcs.numpy(), np.cumsum(sat, axis=1))


def test_unpack_pairs_sign_extends():
    rng = np.random.default_rng(0)
    for dt, wide in ((np.int16, torch.int32), (np.int8, torch.int16)):
        info = np.iinfo(dt)
        s = rng.integers(info.min, info.max + 1, size=(257, 2)).astype(dt)
        s[0], s[1] = (info.min, info.max), (-1, 0)
        i, q = ck.unpack_pairs(torch.from_numpy(packed(s)))
        assert torch.from_numpy(packed(s)).dtype == wide
        np.testing.assert_array_equal(i.numpy(), s[:, 0].astype(np.float32))
        np.testing.assert_array_equal(q.numpy(), s[:, 1].astype(np.float32))


def test_atan2_cephes_close_to_arctan2_and_conventions():
    rng = np.random.default_rng(1)
    y = rng.standard_normal(4096).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    got = ck.atan2_cephes(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=2e-6)
    sp = ck.atan2_cephes(torch.tensor([0.0, 0.0, 1.0, -1.0, -0.0]),
                         torch.tensor([0.0, -1.0, 0.0, 0.0, -2.0])).numpy()
    np.testing.assert_allclose(
        sp, [0.0, np.pi, np.pi / 2, -np.pi / 2, np.pi], atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    taps = tchan.Channelizer.create(M).taps_rev
    with pytest.raises(TypeError):
        ck.channelize_streams_packed_cm2(torch.zeros(64), taps)
    with pytest.raises(ValueError):
        ck.channelize_streams_packed_cm2(
            torch.zeros((8, 8), dtype=torch.int32), taps)


# ------------------------------------------------- the cm form and history

def _split(bw):
    """The capture's packed pairs, cut at a frame: (whole, cut, history of
    the second part = the last P-1 frames of the first)."""
    xq = packed(pulse_capture(bw))
    p = tchan.Channelizer.create(M).taps_per_band
    cut = 400
    return xq, cut, xq[(cut - (p - 1)) * M: cut * M]


@pytest.fixture(scope="module",
                params=[(12, False), (12, True), (8, False), (8, True)],
                ids=["int16", "int16-history", "int8", "int8-history"])
def cm_streams(request):
    """(JAX cm streams cut to the real rows and columns, the port's): the
    whole capture, or its second part entered with the first part's tail."""
    bw, with_history = request.param
    xq, cut, hist = _split(bw)
    taps = jchan.Channelizer.create(M).taps_rev
    if with_history:
        xq = xq[cut * M:]
    else:
        hist = None
    ref = pallas_channelize_streams_packed_cm(
        jnp.asarray(xq), taps, bit_width=bw, block_frames=256, interpret=True,
        history=None if hist is None else jnp.asarray(hist))
    t_len = len(xq) // M
    ref = [np.asarray(r) for r in ref]
    got = ck.channelize_streams_packed_cm(
        torch.from_numpy(xq), taps, bw,
        history=None if hist is None else torch.from_numpy(hist))
    return ([ref[0]] + [r[:M, :t_len] for r in ref[1:]],
            [g.numpy() for g in got], t_len)


def test_cm_shapes(cm_streams):
    ref, got, t_len = cm_streams
    assert got[0].shape == ref[0].shape == (t_len, M)
    for g in got[1:]:
        assert g.shape == (M, t_len) and g.dtype == np.float32
    np.testing.assert_array_equal(got[0], got[1].T)


@pytest.mark.parametrize("stream", [0, 1], ids=["mag", "mag_cm"])
def test_cm_mag_matches_jax_kernel(cm_streams, stream):
    ref, got, _ = cm_streams
    np.testing.assert_allclose(got[stream], ref[stream], rtol=1e-5, atol=1e-5)


def test_cm_dph_matches_jax_kernel(cm_streams):
    ref, got, t_len = cm_streams
    d = (got[2] - ref[2] + 180.0) % 360.0 - 180.0
    loud = ref[1] > 1e-4
    loud[:, :-1] &= loud[:, 1:]
    assert np.abs(d[loud]).max() <= 0.05
    assert not got[2][:, t_len - 1:].any()  # zero at column t_len - 1


def test_cm_sat_mask_matches_jax_kernel_exactly(cm_streams):
    ref, got, _ = cm_streams
    assert set(np.unique(got[3])) <= {0.0, 1.0}
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.mark.parametrize("bw", [12, 8], ids=["int16", "int8"])
def test_cm_form_holds_the_bits_of_the_cm2_form(bw):
    xq = torch.from_numpy(packed(pulse_capture(bw)))
    taps = tchan.Channelizer.create(M).taps_rev
    mag, mag_cm, dph_cm, sat_cm = ck.channelize_streams_packed_cm(xq, taps, bw)
    k1_mag, k1_dph, k1_satcs = ck.channelize_streams_packed_cm2(xq, taps, bw)
    assert torch.equal(mag_cm, k1_mag) and torch.equal(dph_cm, k1_dph)
    assert sat_cm.any() and torch.equal(torch.cumsum(sat_cm, 1), k1_satcs)


@pytest.mark.parametrize("form", ["cm", "cm2"])
@pytest.mark.parametrize("bw", [12, 8], ids=["int16", "int8"])
def test_two_blocks_with_history_equal_one_call(bw, form):
    xq, cut, hist = _split(bw)
    fn = getattr(ck, f"channelize_streams_packed_{form}")
    taps = tchan.Channelizer.create(M).taps_rev
    whole = fn(torch.from_numpy(xq), taps, bw)
    first = fn(torch.from_numpy(xq[: cut * M]), taps, bw)
    second = fn(torch.from_numpy(xq[cut * M:]), taps, bw,
                history=torch.from_numpy(hist))
    for i, (w, a, b) in enumerate(zip(whole, first, second)):
        time_major = w.shape[1] == M
        if form == "cm2" and i == 2:   # the count starts again at the cut
            b = b + a[:, -1:]
        if i == (2 if form == "cm" else 1):
            # the first block ends at the cut, so its last phase step is
            # zero by definition; the whole still knows the next frame
            a = a.clone()
            a[:, -1] = w[:, cut - 1]
        joined = torch.cat([a, b], dim=0 if time_major else 1)
        assert torch.equal(joined, w), (form, i)


def test_short_history_is_padded_on_the_left():
    """A block that starts fewer than P-1 frames into the capture: zeros
    stand before the capture's first frame."""
    bw = 12
    xq = packed(pulse_capture(bw))
    chan = tchan.Channelizer.create(M)
    p = chan.taps_per_band
    cut = p - 4
    hist = np.concatenate([np.zeros((p - 1 - cut) * M, xq.dtype),
                           xq[: cut * M]])
    whole = ck.channelize_streams_packed_cm(torch.from_numpy(xq),
                                            chan.taps_rev, bw)
    part = ck.channelize_streams_packed_cm(
        torch.from_numpy(xq[cut * M:]), chan.taps_rev, bw,
        history=torch.from_numpy(hist))
    assert torch.equal(part[0], whole[0][cut:])
    assert torch.equal(part[1], whole[1][:, cut:])


def test_history_is_checked():
    taps = tchan.Channelizer.create(M).taps_rev
    xq = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.channelize_streams_packed_cm(xq, taps, history=xq[:8])
    with pytest.raises(TypeError):
        ck.channelize_streams_packed_cm2(
            xq, taps, history=torch.zeros(11 * M, dtype=torch.int16))


# ------------------------------- the flat form, the complex form, planes

@pytest.fixture(scope="module",
                params=[(12, False, "packed"), (12, True, "packed"),
                        (8, False, "packed"), (12, False, "planes"),
                        (12, True, "planes")],
                ids=["int16", "int16-history", "int8", "f32-planes",
                     "f32-planes-history"])
def flat_streams(request):
    """(JAX time-major streams, the port's): the whole capture, or its
    second part entered with the first part's tail; packed pairs, or float32
    planes of the dequantized samples."""
    bw, with_history, ingest = request.param
    xq, cut, hist = _split(bw)
    taps = jchan.Channelizer.create(M).taps_rev
    if with_history:
        xq = xq[cut * M:]
    else:
        hist = None
    kw = dict(block_frames=256, interpret=True)
    if ingest == "packed":
        ref = pallas_channelize_streams_packed(
            jnp.asarray(xq), taps, bit_width=bw,
            history=None if hist is None else jnp.asarray(hist), **kw)
        got = ck.channelize_streams_packed(
            torch.from_numpy(xq), taps, bw,
            history=None if hist is None else torch.from_numpy(hist))
    else:
        def planes(v):
            i, q = ck.unpack_pairs(torch.from_numpy(v))
            return (i / 2048.0).numpy(), (q / 2048.0).numpy()

        xr, xi = planes(xq)
        hp = None if hist is None else planes(hist)
        ref = pallas_channelize_streams(
            jnp.asarray(xr), jnp.asarray(xi), taps, bit_width=0,
            history=None if hp is None else tuple(jnp.asarray(h) for h in hp),
            **kw)
        got = ck.channelize_streams(
            torch.from_numpy(xr), torch.from_numpy(xi), taps, 0,
            history=None if hp is None else tuple(torch.from_numpy(h)
                                                  for h in hp))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_flat_mag_matches_jax_kernel(flat_streams):
    ref, got = flat_streams
    assert got[0].shape == ref[0].shape and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)


def test_flat_phase_matches_jax_kernel(flat_streams):
    ref, got = flat_streams
    assert np.abs(got[1]).max() <= 180.0
    d = (got[1] - ref[1] + 180.0) % 360.0 - 180.0
    # the planes agree to 1e-5, so a phase may differ by the angle that
    # subtends at the sample's magnitude
    slack = np.rad2deg(1e-5 / np.maximum(ref[0], 1e-30))
    loud = ref[0] > 1e-4
    assert np.all(np.abs(d[loud]) <= 1e-3 + slack[loud])
    assert np.abs(d[ref[0] > 1e-2]).max() <= 0.005


def test_flat_mask_matches_jax_kernel_exactly(flat_streams):
    ref, got = flat_streams
    assert set(np.unique(got[2])) <= {0.0, 1.0}
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("bw", [12, 8], ids=["int16", "int8"])
def test_flat_form_holds_the_bits_of_the_cm_form(bw):
    xq = torch.from_numpy(packed(pulse_capture(bw)))
    taps = tchan.Channelizer.create(M).taps_rev
    mag, ph, sat = ck.channelize_streams_packed(xq, taps, bw)
    mag_tm, mag_cm, dph_cm, sat_cm = ck.channelize_streams_packed_cm(
        xq, taps, bw)
    assert torch.equal(mag, mag_tm) and torch.equal(sat, sat_cm.T)
    assert sat.any()
    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)
    assert torch.equal(d.T, dph_cm[:, :-1])


@pytest.mark.parametrize("form", ["flat", "cm", "cm2"])
@pytest.mark.parametrize("planes", ["int16", "float32"])
def test_planes_ingest_holds_the_bits_of_the_packed_ingest(form, planes):
    """Raw int16 planes with the bit width, or their float32 dequantization
    with bit width 0, with and without a history."""
    xq, cut, hist = _split(12)
    taps = tchan.Channelizer.create(M).taps_rev
    name = {"flat": "", "cm": "_cm", "cm2": "_cm2"}[form]
    packed_fn = getattr(ck, f"channelize_streams_packed{name}")
    planes_fn = getattr(ck, f"channelize_streams{name}")

    def split(v):
        i, q = ck.unpack_pairs(torch.from_numpy(v))
        if planes == "int16":
            return i.to(torch.int16), q.to(torch.int16)
        return i / 2048.0, q / 2048.0

    bw = 12 if planes == "int16" else 0
    whole = packed_fn(torch.from_numpy(xq), taps, 12)
    got = planes_fn(*split(xq), taps, bw)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    part = packed_fn(torch.from_numpy(xq[cut * M:]), taps, 12,
                     history=torch.from_numpy(hist))
    got = planes_fn(*split(xq[cut * M:]), taps, bw, history=split(hist))
    for a, b in zip(got, part):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def complex_bands():
    """(the JAX complex kernel's bands in interpret mode, the port's)."""
    x = jiq.to_complex(pulse_capture(12), 12)
    taps = jchan.Channelizer.create(M).taps_rev
    ref = pallas_channelize(jnp.asarray(x), taps, block_frames=256,
                            interpret=True)
    return x, np.asarray(ref), ck.channelize_complex(torch.from_numpy(x), taps)


def test_complex_form_matches_jax_kernel(complex_bands):
    x, ref, got = complex_bands
    assert got.shape == ref.shape == (len(x) // M, M)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_complex_form_is_the_ports_dft_channelizer(complex_bands):
    x, _, got = complex_bands
    chan = tchan.Channelizer.create(M)
    y = tchan.channelize(x, chan, method="dft", device="cpu")
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x)
    planes = ck.channelize_complex_planes(xt.real.contiguous(),
                                          xt.imag.contiguous(), chan.taps_rev)
    assert torch.equal(torch.view_as_real(planes), torch.view_as_real(got))
    flat = ck.channelize_streams_packed(
        torch.from_numpy(packed(pulse_capture(12))), chan.taps_rev, 12)
    np.testing.assert_allclose(got.abs().numpy(), flat[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    no_shift = ck.channelize_complex(xt, chan.taps_rev, shift=False)
    assert torch.equal(torch.fft.fftshift(no_shift, dim=-1), got)


def test_planes_wrappers_reject_what_the_kernel_does_not_take():
    taps = tchan.Channelizer.create(M).taps_rev
    f = torch.zeros(64)
    with pytest.raises(TypeError):
        ck.channelize_streams(f.double(), f.double(), taps)
    with pytest.raises(TypeError):
        ck.channelize_streams(f, f.to(torch.int16), taps)
    with pytest.raises(ValueError):
        ck.channelize_streams(f, f[:32], taps)
    with pytest.raises(ValueError):
        ck.channelize_streams_cm2(f, f, taps, history=(f[:8], f[:8]))
    with pytest.raises(TypeError):
        ck.channelize_complex(f, taps)
    with pytest.raises(TypeError):
        ck.channelize_complex_planes(f.to(torch.int16), f.to(torch.int16),
                                     taps)
