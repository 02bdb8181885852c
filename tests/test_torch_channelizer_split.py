"""The precision plan of the channelizer kernel's tensor-core DFT, shown on
the CPU before any card runs it.

On the card the kernel computes the DFT's four real products with
``mma.sync`` in TF32, keeping float32 accuracy by a split of both factors:
``x = hi + lo`` with ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``
(round to nearest, ties away from zero, to 10 mantissa bits), and a product
``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi``, the two small terms summed apart and
added to the large one at the end.  Here that split is emulated in torch
(the rounding on the bit pattern, three float32 products, the small terms
first) and held against the JAX package's channelizer kernel in interpret
mode at the kernel's tolerance, rtol = atol = 1e-5, and against the port's
plain version.  The order in which the tensor cores accumulate inside a
product is not emulated: torch's float32 matrix product sums in its own
order, which is why the comparison is at a tolerance and not bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.dsp import channelizer as jchan
from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu.ops.pallas.channelizer_kernel import (
    pallas_channelize_streams_packed_cm2,
)
from sdr_channelizer_tpu_torch.dsp.channelizer import dft_matrix, fir_branches
from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
from sdr_channelizer_tpu_torch.ops.cuda.latch_kernel import latch_cumsums_plain
from sdr_channelizer_tpu_torch.ops.cuda.nf_kernel import noise_floor_cm_plain
from torch_port_fixtures import packed, pulse_capture

torch.set_num_threads(1)

TOL = 1e-5        # the kernel's tolerance against its plain version
SPLIT_TOL = 2e-6  # what the emulated split keeps of float32


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by the rna rule, on the bit pattern."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_product(a, b):
    """a @ b as the kernel forms it: small terms apart, then the large one."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    small = a_lo @ b_hi + a_hi @ b_lo
    return a_hi @ b_hi, small


def emulated_planes(samples, m, bit_width):
    """(yr, yi), (T, M) float32, of the split-TF32 DFT of the plain FIR."""
    xq = torch.from_numpy(packed(samples))
    i, q = ck.unpack_pairs(xq)
    t_len = len(xq) // m
    scale = float(2.0 ** -(bit_width - 1))
    taps = torch.from_numpy(jchan.Channelizer.create(m).taps_rev
                            .astype(np.float32))
    ur = fir_branches((i[:t_len * m] * scale).reshape(t_len, m), taps)
    ui = fir_branches((q[:t_len * m] * scale).reshape(t_len, m), taps)
    w = dft_matrix(m)
    wr = torch.from_numpy(np.ascontiguousarray(w.real))
    wi = torch.from_numpy(np.ascontiguousarray(w.imag))
    parts = [split_product(ur, wr), split_product(-ui, wi),
             split_product(ur, wi), split_product(ui, wr)]
    yr = (parts[0][0] + parts[1][0]) + (parts[0][1] + parts[1][1])
    yi = (parts[2][0] + parts[3][0]) + (parts[2][1] + parts[3][1])
    return yr, yi


def streams(yr, yi, sat_level=0.9999):
    """The cm2 streams, channel-major, from the planes (the plain
    version's epilogue)."""
    mag = torch.sqrt(yr * yr + yi * yi)
    ph = ck.atan2_cephes(yi, yr) * float(np.float32(180.0 / np.pi))
    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)
    dph = torch.cat([d, d.new_zeros((1, d.shape[1]))])
    sat = ((yr.abs() >= sat_level) | (yi.abs() >= sat_level)).to(torch.float32)
    return mag.T, dph.T, torch.cumsum(sat, dim=0).T


def tone_capture(m, frames, bit_width=12, seed=11):
    """A pulsed tone in noise with a clipped stretch, (N, 2) integers."""
    rng = np.random.default_rng(seed)
    n = m * frames
    t = np.arange(n)
    iq = 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    tone = 0.5 * np.exp(2j * np.pi * (2.3 / m) * t)
    for s in range(3 * m, n - 40 * m, 70 * m):
        iq[s:s + 25 * m] = tone[s:s + 25 * m]
    iq[n // 2:n // 2 + 2 * m] = 1.0 + 1.0j
    return jiq.from_complex(iq.astype(np.complex64), bit_width)


def test_rna_rule_and_the_kernel_weights():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    ties = (np.arange(1, 65, dtype=np.uint32) << 13 | 0x1000)  # exactly half
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32)])
    got = rna_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ck.tf32_rna(x))
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # ties round away from zero
    away = (ties >> 13 << 13) + 0x2000
    np.testing.assert_array_equal(np.abs(got[4096:]).view(np.uint32),
                                  np.concatenate([away, away]))
    # the kernel's W fragments are hi + lo of the DFT planes
    for m in (8, 12, 64):
        frag = ck.dft_fragments(m)
        w = dft_matrix(m)
        kp = (m + 7) // 8 * 8
        assert frag.shape == (kp // 8, kp // 8, 32, 8)
        lane = np.arange(32)
        n = np.arange(kp // 8)[:, None, None] * 8 + (lane >> 2)
        k0 = np.arange(kp // 8)[None, :, None] * 8 + (lane & 3)
        for part, off in ((w.real, 0), (w.imag, 4)):
            full = np.zeros((kp, kp), np.float32)
            full[:m, :m] = part
            hi = ck.tf32_rna(full)
            for j, k in enumerate((k0, k0 + 4)):
                np.testing.assert_array_equal(frag[..., off + j], hi[k, n])
                np.testing.assert_array_equal(frag[..., off + 2 + j],
                                              ck.tf32_rna(full - hi)[k, n])


@pytest.fixture(scope="module", params=[8, 64], ids=["M8", "M64"])
def case(request):
    """(M, samples, JAX streams cut to the real rows and columns)."""
    m = request.param
    samples = tone_capture(m, 320)
    taps = jchan.Channelizer.create(m).taps_rev
    ref = pallas_channelize_streams_packed_cm2(
        jnp.asarray(packed(samples)), taps, bit_width=12, block_frames=256,
        interpret=True)
    t_len = len(samples) // m
    return m, samples, [np.asarray(r)[:m, :t_len] for r in ref]


def test_split_planes_keep_float32_accuracy(case):
    m, samples, _ = case
    yr, yi = emulated_planes(samples, m, 12)
    pr, pi = ck.channelize_planes_plain(torch.from_numpy(packed(samples)),
                                        jchan.Channelizer.create(m).taps_rev,
                                        12)
    np.testing.assert_allclose(yr, pr, rtol=0, atol=SPLIT_TOL)
    np.testing.assert_allclose(yi, pi, rtol=0, atol=SPLIT_TOL)


def test_split_streams_match_jax_kernel(case):
    m, samples, ref = case
    mag, dph, satcs = streams(*emulated_planes(samples, m, 12))
    np.testing.assert_allclose(mag, ref[0], rtol=TOL, atol=TOL)
    d = (dph.numpy() - ref[1] + 180.0) % 360.0 - 180.0
    loud = ref[0] > 1e-2
    loud[:, :-1] &= loud[:, 1:]
    assert np.abs(d[loud]).max() <= 0.05
    assert ref[2].max() > 0   # the clipped stretch saturates
    np.testing.assert_array_equal(satcs, ref[2])


@pytest.mark.parametrize("hysteresis", [False, True])
def test_split_magnitudes_give_the_same_edges(hysteresis):
    """On a clipped synthetic capture, the latch finds the same edges in
    the emulated product's magnitudes as in the plain version's."""
    m = 8
    samples = pulse_capture(12, m)
    yr, yi = emulated_planes(samples, m, 12)
    pr, pi = ck.channelize_planes_plain(torch.from_numpy(packed(samples)),
                                        jchan.Channelizer.create(m).taps_rev,
                                        12)
    mag = torch.sqrt(yr * yr + yi * yi)
    plain = torch.sqrt(pr * pr + pi * pi)
    nf = noise_floor_cm_plain(plain.T.contiguous(), plain.shape[0])
    lead = nf * 10.0 ** 1.2
    trail = nf * 10.0 ** 0.3 if hysteresis else lead
    got = latch_cumsums_plain(mag, lead, trail)
    want = latch_cumsums_plain(plain, lead, trail)
    assert torch.equal(got, want)
    assert want[:m, -1].sum() >= 3   # pulses were found
