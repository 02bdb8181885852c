"""The channelizer kernel in its four forms: capture -> detection streams,
or the complex bands.

The counterparts of ``pallas_channelize_streams[_packed]_cm2``,
``pallas_channelize_streams[_packed]_cm``,
``pallas_channelize_streams[_packed]`` and ``pallas_channelize`` of the JAX
package: sign-extend and dequantize the samples, the polyphase branch FIR
over the ``history`` frames of the previous block (zeros by default), the
shift-folded DFT (on the card on the tensor cores, as three TF32 products of
a hi + lo split that keep float32 accuracy), then one of four outputs.  The
cm2 form gives the channel-major streams of the PDW front end with the
saturation as a cumulative count; the cm form gives it as a 0/1 mask and
adds the time-major magnitude that the streamed noise floor and the
time-major latch read; the flat form gives the time-major magnitude, phase in
degrees and 0/1 mask; the complex form gives the bands themselves.

The stream forms (cm2 and flat) also take ``w_parts=(wr, wi)``: an (M,
n_bands) column slice of the shift-folded DFT matrix, a band slice as the
channel-sharded pipeline (``parallel``) hands each mesh column.  The kernel
then contracts over all M branches and emits those n_bands bands only, each
the same bits as the full matrix's band on the card (the split of a W entry
and the order of the k-steps do not change).

The capture comes as packed pairs (``*_packed*``: one int32 holding an int16
(I, Q) pair, or one int16 holding an int8 pair: the recorder's bytes as they
are on disk) or as two planes (int16, dequantized by ``bit_width``, or
float32 with ``bit_width=0``).

Every wrapper launches the CUDA kernel (``csrc/channelizer.cu``, one body
for all forms and ingests) for CUDA tensors, or raises; for CPU tensors it
takes its ``_plain`` version, the plain PyTorch form of the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

# times the kernel was launched in each form (either ingest)
launches = 0          # cm2: channelize_streams[_packed]_cm2
launches_cm = 0       # cm: channelize_streams[_packed]_cm
launches_flat = 0     # flat: channelize_streams[_packed]
launches_complex = 0  # complex: channelize_complex[_planes]

_MODE_CM2, _MODE_CM, _MODE_FLAT, _MODE_COMPLEX = range(4)
_PACKED = {torch.int32: 0, torch.int16: 1}   # dtype -> ingest code
_PLANES = {torch.int16: 2, torch.float32: 3}

_weights = {}  # (device, shift, taps bytes) -> (taps, W fragments)


def _check_args(xq: torch.Tensor, taps_rev) -> Tuple[int, int, int]:
    if xq.dtype not in _PACKED:
        raise TypeError(
            f"xq must be int32 (int16 I/Q pairs) or int16 (int8 pairs), got "
            f"{xq.dtype}")
    if xq.ndim != 1 or not xq.is_contiguous():
        raise ValueError("xq must be a contiguous 1-D tensor of packed pairs")
    p, m = taps_rev.shape
    return p, m, xq.shape[0] // m


def _check_history(history, xq: torch.Tensor, p: int, m: int):
    """The (P-1, M) packed frames before the block, flat, or None."""
    if history is None:
        return None
    if history.dtype != xq.dtype or history.device != xq.device:
        raise TypeError("history must have the dtype and device of xq")
    if history.numel() != (p - 1) * m:
        raise ValueError(f"history must hold (P-1, M) = ({p - 1}, {m}) "
                         f"packed frames, got {tuple(history.shape)}")
    return history.reshape(-1).contiguous()


def unpack_pairs(xq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended (I, Q) of the packed pairs, as float32.  int32: low
    half I, high half Q; int16: low byte I, high byte Q."""
    v = xq.to(torch.int32)
    if xq.dtype == torch.int32:
        i, q = (v << 16) >> 16, v >> 16
    else:
        i, q = (v << 24) >> 24, v >> 8
    return i.to(torch.float32), q.to(torch.float32)


def _atan_poly(z: torch.Tensor) -> torch.Tensor:
    s = z * z
    return ((((8.05374449538e-2 * s - 1.38776856032e-1) * s + 1.99777106478e-1)
             * s - 3.33329491539e-1) * s * z + z)


def atan2_cephes(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 from compares and the Cephes single-precision polynomial (the
    three-interval reduction the kernels use; about 1e-6 rad from
    ``torch.atan2``).  ``x = y = 0 -> 0``; ``y = 0, x < 0 -> +pi``."""
    pi = float(np.float32(np.pi))
    ay, ax = y.abs(), x.abs()
    inf = torch.full_like(ax, float("inf"))
    z = torch.where(ax == 0, inf, ay / torch.where(ax == 0, torch.ones_like(ax), ax))
    t_hi, t_lo = 2.414213562373095, 0.4142135623730950
    inv = 1.0 / torch.clamp(z, min=1e-30)
    mid = (z - 1.0) / (z + 1.0)
    arg = torch.where(z > t_hi, inv, torch.where(z > t_lo, mid, z))
    base = _atan_poly(arg)
    t = torch.where(z > t_hi, pi / 2 - base,
                    torch.where(z > t_lo, pi / 4 + base, base))
    t = torch.where(torch.isinf(z), torch.full_like(t, pi / 2), t)
    ang = torch.where(x < 0, pi - t, t)
    ang = torch.where(y < 0, -ang, ang)
    ang = torch.where((y == 0) & (x < 0), torch.full_like(ang, pi), ang)
    return torch.where((y == 0) & (x == 0), torch.zeros_like(ang), ang)


@dataclasses.dataclass
class _Source:
    """A capture as the kernel reads it: ``x0`` the packed plane or the I
    plane, ``x1`` the Q plane or None, ``h0`` / ``h1`` the (P-1) * M samples
    before the block (or None), ``stride`` the element stride of a plane in
    memory (2 for the planes of a complex64 capture read in place)."""

    ingest: int
    x0: torch.Tensor
    x1: Optional[torch.Tensor]
    h0: Optional[torch.Tensor]
    h1: Optional[torch.Tensor]
    stride: int
    scale: float
    p: int
    m: int
    t_len: int

    @property
    def device(self):
        return self.x0.device

    def floats(self):
        """``(vi, vq, hi, hq)``: the dequantized (t_len, M) frames and the
        (P-1, M) history frames (or None, None), float32."""
        n = self.t_len * self.m
        if self.x1 is None:
            vi, vq = unpack_pairs(self.x0[:n])
            hi, hq = (None, None) if self.h0 is None else unpack_pairs(self.h0)
        else:
            vi, vq = (v[:n].to(torch.float32) for v in (self.x0, self.x1))
            hi, hq = (None if h is None else h.to(torch.float32)
                      for h in (self.h0, self.h1))

        def frames(v, rows):
            return None if v is None else (v * self.scale).reshape(rows, self.m)

        return (frames(vi, self.t_len), frames(vq, self.t_len),
                frames(hi, self.p - 1), frames(hq, self.p - 1))


def _packed_source(xq, taps_rev, bit_width, history) -> _Source:
    p, m, t_len = _check_args(xq, taps_rev)
    return _Source(_PACKED[xq.dtype], xq, None,
                   _check_history(history, xq, p, m), None, 1,
                   float(2.0 ** -(bit_width - 1)), p, m, t_len)


def _planes_source(xr, xi, taps_rev, bit_width, history) -> _Source:
    if xr.dtype not in _PLANES or xi.dtype != xr.dtype:
        raise TypeError(
            f"xr and xi must both be int16 or float32 planes, got {xr.dtype} "
            f"and {xi.dtype}")
    if xr.ndim != 1 or xr.shape != xi.shape or xr.device != xi.device \
            or not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("xr and xi must be contiguous 1-D planes of one "
                         "length on one device")
    p, m = taps_rev.shape
    h0 = h1 = None
    if history is not None:
        h0, h1 = (_check_history(h, xr, p, m) for h in history)
    scale = float(2.0 ** -(bit_width - 1)) if bit_width else 1.0
    return _Source(_PLANES[xr.dtype], xr, xi, h0, h1, 1, scale, p, m,
                   xr.shape[0] // m)


def _complex_source(x, taps_rev) -> _Source:
    """A complex64 capture read in place as two float32 planes of stride 2."""
    if x.dtype != torch.complex64 or x.ndim != 1 or not x.is_contiguous():
        raise TypeError("x must be a contiguous 1-D complex64 tensor")
    p, m = taps_rev.shape
    pairs = torch.view_as_real(x)
    return _Source(_PLANES[torch.float32], pairs[:, 0], pairs[:, 1], None,
                   None, 2, 1.0, p, m, x.shape[0] // m)


def band_slice(w_parts, m: int):
    """``w_parts`` as two contiguous (M, n_bands) float32 host arrays, or
    None for the full matrix."""
    if w_parts is None:
        return None
    wr, wi = (np.ascontiguousarray(
        w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w,
        np.float32) for w in w_parts)
    if wr.ndim != 2 or wr.shape != wi.shape or wr.shape[0] != m \
            or wr.shape[1] < 1:
        raise ValueError(f"w_parts must be two (M, n_bands) = ({m}, n) "
                         f"arrays, got {wr.shape} and {wi.shape}")
    return wr, wi


def _w_planes(m: int, shift: bool, w_parts):
    """The (M, n_bands) real and imaginary DFT planes: the slice given, or
    the whole shift-folded matrix."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import dft_matrix

    if w_parts is not None:
        return w_parts
    w = dft_matrix(m, shifted=shift)
    return (np.ascontiguousarray(w.real, np.float32),
            np.ascontiguousarray(w.imag, np.float32))


def _planes_plain(src: _Source, taps_rev, shift: bool = True, w_parts=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (T, n_bands) real and imaginary planes of the channelizer
    output in plain PyTorch (matmul in full float32); ``w_parts`` as
    returned by :func:`band_slice`."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import fir_branches

    dev = src.device
    vi, vq, hi, hq = src.floats()
    taps = torch.as_tensor(np.asarray(taps_rev, np.float32), device=dev)
    ur = fir_branches(vi, taps, hi)
    ui = fir_branches(vq, taps, hq)
    wr, wi = (torch.as_tensor(w, device=dev)
              for w in _w_planes(src.m, shift, w_parts))
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain version needs full-float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    yr = ur @ wr - ui @ wi
    yi = ur @ wi + ui @ wr
    return yr, yi


def channelize_planes_plain(xq: torch.Tensor, taps_rev, bit_width: int,
                            shift: bool = True,
                            history: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (T, M) real and imaginary planes of the channelizer output, from
    the packed capture, in plain PyTorch (matmul in full float32)."""
    return _planes_plain(_packed_source(xq, taps_rev, bit_width, history),
                         taps_rev, shift)


def _flat_plain(src, taps_rev, sat_level, shift, w_parts=None):
    """Time-major (T, n_bands) ``(mag, phase_deg, sat)``: the flat form."""
    yr, yi = _planes_plain(src, taps_rev, shift, w_parts)
    mag = torch.sqrt(yr * yr + yi * yi)
    ph = atan2_cephes(yi, yr) * float(np.float32(180.0 / np.pi))
    sat = ((yr.abs() >= sat_level) | (yi.abs() >= sat_level)).to(torch.float32)
    return mag, ph, sat


def _cm_plain(src, taps_rev, sat_level, shift, w_parts=None):
    """Time-major (T, n_bands) ``(mag, dph, sat)`` shared by the cm and cm2
    plain forms."""
    mag, ph, sat = _flat_plain(src, taps_rev, sat_level, shift, w_parts)
    t_len, m = mag.shape
    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)  # strict: exactly +-180 stays
    dph = torch.cat([d, d.new_zeros((min(t_len, 1), m))], dim=0)
    return mag, dph, sat


def _cm2_outputs_plain(src, taps_rev, sat_level, shift, w_parts=None):
    mag, dph, sat = _cm_plain(src, taps_rev, sat_level, shift, w_parts)
    return (mag.T.contiguous(), dph.T.contiguous(),
            torch.cumsum(sat, dim=0).T.contiguous())


def _cm_outputs_plain(src, taps_rev, sat_level, shift):
    mag, dph, sat = _cm_plain(src, taps_rev, sat_level, shift)
    return (mag, mag.T.contiguous(), dph.T.contiguous(), sat.T.contiguous())


def channelize_streams_packed_cm2_plain(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    history: Optional[torch.Tensor] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`channelize_streams_packed_cm2`."""
    return _cm2_outputs_plain(
        _packed_source(xq, taps_rev, bit_width, history), taps_rev, sat_level,
        shift, band_slice(w_parts, taps_rev.shape[1]))


def channelize_streams_packed_cm_plain(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    history: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`channelize_streams_packed_cm`."""
    return _cm_outputs_plain(
        _packed_source(xq, taps_rev, bit_width, history), taps_rev, sat_level,
        shift)


def channelize_streams_packed_plain(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    history: Optional[torch.Tensor] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`channelize_streams_packed`."""
    return _flat_plain(_packed_source(xq, taps_rev, bit_width, history),
                       taps_rev, sat_level, shift,
                       band_slice(w_parts, taps_rev.shape[1]))


def channelize_streams_plain(xr, xi, taps_rev, bit_width: int = 0,
                             sat_level: float = 0.9999, shift: bool = True,
                             history=None, w_parts=None):
    """Plain PyTorch version of :func:`channelize_streams`."""
    return _flat_plain(_planes_source(xr, xi, taps_rev, bit_width, history),
                       taps_rev, sat_level, shift,
                       band_slice(w_parts, taps_rev.shape[1]))


def channelize_streams_cm_plain(xr, xi, taps_rev, bit_width: int = 0,
                                sat_level: float = 0.9999, shift: bool = True,
                                history=None):
    """Plain PyTorch version of :func:`channelize_streams_cm`."""
    return _cm_outputs_plain(
        _planes_source(xr, xi, taps_rev, bit_width, history), taps_rev,
        sat_level, shift)


def channelize_streams_cm2_plain(xr, xi, taps_rev, bit_width: int = 0,
                                 sat_level: float = 0.9999, shift: bool = True,
                                 history=None, w_parts=None):
    """Plain PyTorch version of :func:`channelize_streams_cm2`."""
    return _cm2_outputs_plain(
        _planes_source(xr, xi, taps_rev, bit_width, history), taps_rev,
        sat_level, shift, band_slice(w_parts, taps_rev.shape[1]))


def channelize_complex_plain(x: torch.Tensor, taps_rev,
                             shift: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_complex`: the four real
    products of ``channelize(method="dft")``."""
    yr, yi = _planes_plain(_complex_source(x, taps_rev), taps_rev, shift)
    return torch.complex(yr, yi)


def channelize_complex_planes_plain(xr, xi, taps_rev,
                                    shift: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`channelize_complex_planes`."""
    yr, yi = _planes_plain(_planes_source(xr, xi, taps_rev, 0, None),
                           taps_rev, shift)
    return torch.complex(yr, yi)


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """``a`` (float32) rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero: the rule of ``cvt.rna.tf32.f32``, on the bit pattern."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def dft_fragments(m: int, shift: bool = True, w_parts=None) -> np.ndarray:
    """The DFT planes split for the kernel's three TF32 products, in the
    order of its B fragments: ``(NT, KS, 32, 8)`` float32 with KS = M
    rounded up to 8, over 8, and NT = KS, or with a band slice ``w_parts``
    (as :func:`band_slice` returns it) its n_bands rounded up to 8, over 8:
    the slice's entries split as the full matrix's, over the same k-steps.
    Block ``[n, k]`` is the 8 x 8 tile of ``W``
    for channels ``8n ..`` and branches ``8k ..``; lane ``l`` holds, for
    channel ``8n + l // 4`` and branches ``c0 = 8k + l % 4`` and ``c0 + 4``:
    ``wr`` hi at both, ``wr`` lo at both, ``wi`` hi at both, ``wi`` lo at
    both, where ``hi = tf32_rna(w)`` and ``lo = tf32_rna(w - hi)``.  Pad rows
    and columns are zero."""
    kp = (m + 7) // 8 * 8
    parts = _w_planes(m, shift, w_parts)
    n_bands = parts[0].shape[1]
    np_ = (n_bands + 7) // 8 * 8
    planes = []
    for part in parts:
        full = np.zeros((kp, np_), np.float32)   # [branch, channel]
        full[:m, :n_bands] = part
        hi = tf32_rna(full)
        planes += [hi, tf32_rna(full - hi)]
    wr_hi, wr_lo, wi_hi, wi_lo = planes
    lane = np.arange(32)
    n = np.arange(np_ // 8)[:, None, None] * 8 + (lane >> 2)[None, None, :]
    k0 = np.arange(kp // 8)[None, :, None] * 8 + (lane & 3)[None, None, :]
    k1 = k0 + 4
    return np.ascontiguousarray(np.stack(
        [wr_hi[k0, n], wr_hi[k1, n], wr_lo[k0, n], wr_lo[k1, n],
         wi_hi[k0, n], wi_hi[k1, n], wi_lo[k0, n], wi_lo[k1, n]], axis=-1),
        np.float32)


def _device_weights(taps_rev, shift: bool, dev, w_parts=None):
    """The taps (columns padded with zeros to a multiple of 4) and the split
    DFT planes (or band slice) in fragment order on the device, kept from
    call to call: set-up, not part of a step."""
    taps = np.ascontiguousarray(taps_rev, np.float32)
    key = (dev, shift, taps.shape, taps.tobytes(),
           None if w_parts is None else
           (w_parts[0].shape, w_parts[0].tobytes(), w_parts[1].tobytes()))
    hit = _weights.get(key)
    if hit is None:
        p, m = taps.shape
        padded = np.zeros((p, (m + 3) // 4 * 4), np.float32)
        padded[:, :m] = taps
        if len(_weights) >= 16:
            _weights.clear()
        hit = tuple(torch.as_tensor(a, device=dev)
                    for a in (padded, dft_fragments(m, shift, w_parts)))
        _weights[key] = hit
    return hit


def _library():
    import ctypes

    lib = _build.load("channelizer")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdr_channelize.argtypes = (
            [ci, ci] + [vp] * 4 + [ci] + [vp] * 9 + [ci] * 7 + [cf, cf, vp])
        lib.sdr_channelize.restype = ci
        lib.sdr_channelize_plan.argtypes = [ci, ci, ci, ci,
                                            ctypes.POINTER(ci)]
        lib.sdr_channelize_plan.restype = ctypes.c_longlong
        lib._sdr_typed = True
    return lib


def _tile(src: _Source, tile_frames: Optional[int], mode: int,
          n_bands: int) -> Tuple[int, int, int]:
    """``(frames a tile, n-tiles, k-steps of a chunk of W)``.  A tile has a
    multiple of 16 rows: its frames, plus the look-ahead frame in the cm2
    and cm modes.  The caller's tile length, checked, or the plan that
    ``sdr_channelize_plan`` prefers: the longest tile that keeps all of W in
    shared memory with room for two blocks a multiprocessor."""
    import ctypes

    ahead = 1 if mode in (_MODE_CM2, _MODE_CM) else 0
    rows = 0 if tile_frames is None else tile_frames + ahead
    plan = (ctypes.c_int * 3)()
    if (tile_frames is None or rows > 0) and _library().sdr_channelize_plan(
            src.m, n_bands, src.p, rows, plan) > 0:
        return plan[0] - ahead, plan[1], plan[2]
    if tile_frames is not None:
        raise ValueError(
            f"tile_frames={tile_frames} must make tiles of a multiple of 16 "
            f"rows (frames + {ahead} look-ahead) that fit shared memory")
    raise ValueError(
        f"channelizer kernel: M={src.m} bands with P={src.p} taps per band do "
        f"not fit one block's shared memory")


def _n_bands(src: _Source, w_parts) -> int:
    return src.m if w_parts is None else w_parts[0].shape[1]


def _launch(mode: int, src: _Source, taps_rev, shift, tile_frames, outs,
            sat_level: float = 0.0, tile_tot=None, w_parts=None) -> None:
    """Launch the kernel in ``mode`` on ``src`` with the tiles
    ``_tile(src, tile_frames, mode, n_bands)`` gives.  ``outs``: the six
    output tensors in the kernel's order (time-major first, then
    channel-major), None where the mode writes none; ``tile_tot``: a
    callable of the tile length giving the cm2 form's (n_bands, tiles) int32
    scratch; ``w_parts``: a band slice as :func:`band_slice` returns it."""
    p, m, t_len = src.p, src.m, src.t_len
    n_bands = _n_bands(src, w_parts)
    dev = src.device
    ft, nct, kcs = _tile(src, tile_frames, mode, n_bands)
    taps_d, w_d = _device_weights(taps_rev, shift, dev, w_parts)
    tot = None if tile_tot is None else tile_tot(ft)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        code = _library().sdr_channelize(
            mode, src.ingest, ptr(src.x0), ptr(src.x1), ptr(src.h0),
            ptr(src.h1), src.stride, taps_d.data_ptr(), w_d.data_ptr(),
            *(ptr(o) for o in outs), ptr(tot), m, n_bands, p, t_len, ft, nct,
            kcs,
            src.scale, float(sat_level),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, f"sdr_channelize (mode {mode})")


def _run_cm2(src, taps_rev, sat_level, shift, tile_frames, w_parts=None):
    global launches
    if src.t_len >= 1 << 24:
        raise ValueError("satcs_cm counts are float32: t_len must be < 2^24")
    dev = src.device
    n_bands = _n_bands(src, w_parts)
    mag = torch.empty((n_bands, src.t_len), dtype=torch.float32, device=dev)
    dph = torch.empty_like(mag)
    satcs = torch.empty_like(mag)
    if src.t_len == 0:
        return mag, dph, satcs
    _launch(_MODE_CM2, src, taps_rev, shift, tile_frames,
            (None, None, None, mag, dph, satcs), sat_level,
            lambda ft: torch.empty((n_bands, (src.t_len + ft - 1) // ft),
                                   dtype=torch.int32, device=dev), w_parts)
    launches += 1
    return mag, dph, satcs


def _run_cm(src, taps_rev, sat_level, shift, tile_frames):
    global launches_cm
    dev = src.device
    mag_tm = torch.empty((src.t_len, src.m), dtype=torch.float32, device=dev)
    mag = torch.empty((src.m, src.t_len), dtype=torch.float32, device=dev)
    dph = torch.empty_like(mag)
    sat = torch.empty_like(mag)
    if src.t_len == 0:
        return mag_tm, mag, dph, sat
    _launch(_MODE_CM, src, taps_rev, shift, tile_frames,
            (mag_tm, None, None, mag, dph, sat), sat_level)
    launches_cm += 1
    return mag_tm, mag, dph, sat


def _run_flat(src, taps_rev, sat_level, shift, tile_frames, w_parts=None):
    global launches_flat
    mag = torch.empty((src.t_len, _n_bands(src, w_parts)),
                      dtype=torch.float32, device=src.device)
    ph = torch.empty_like(mag)
    sat = torch.empty_like(mag)
    if src.t_len == 0:
        return mag, ph, sat
    _launch(_MODE_FLAT, src, taps_rev, shift, tile_frames,
            (mag, ph, sat, None, None, None), sat_level, w_parts=w_parts)
    launches_flat += 1
    return mag, ph, sat


def _run_complex(src, taps_rev, shift, tile_frames):
    global launches_complex
    y = torch.empty((src.t_len, src.m), dtype=torch.complex64,
                    device=src.device)
    if src.t_len == 0:
        return y
    _launch(_MODE_COMPLEX, src, taps_rev, shift, tile_frames,
            (y, None, None, None, None, None))
    launches_complex += 1
    return y


def channelize_streams_packed_cm2(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[torch.Tensor] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed ingest -> ``(mag_cm, dph_cm, satcs_cm)``, each (M, t_len) f32.

    ``xq`` packs one (I, Q) pair per element: int32 holding an int16 pair
    (low half I) or int16 holding an int8 pair (low byte I); ``t_len =
    len(xq) // M`` frames are used.  ``taps_rev`` is the (P, M) frame-aligned
    polyphase matrix.  ``history`` is the (P-1, M) packed tail of the block
    before this one, in the dtype of ``xq``: the FIR state the block enters
    with (default zeros, the initial state of a capture).  ``mag_cm = |y|``;
    ``dph_cm[:, t]`` is the phase step from frame ``t`` to ``t + 1`` in
    degrees, wrapped once into [-180, 180] with strict inequalities, and
    zero at column ``t_len - 1``; ``satcs_cm`` is the inclusive count along
    time of samples with ``|Re| >= sat_level`` or ``|Im| >= sat_level``.

    The outputs have exactly M rows and ``t_len`` columns: no pad rows and
    no pad columns (the JAX kernel's have M rounded up to 8 and the time
    axis rounded up to its block).  On the card the DFT runs on the tensor
    cores as three TF32 products of a hi + lo split of both factors, which
    keeps float32 accuracy (rtol = atol = 1e-5 against the plain version).
    ``tile_frames``: frames a tile, such that they and the look-ahead frame
    make a multiple of 16 rows (default: chosen by shared memory).
    ``w_parts``: ``(wr, wi)``, an (M, n_bands) column slice of the
    shift-folded DFT matrix (``shift`` is then not read); the streams have
    n_bands rows, each the full matrix's band bit for bit on the card.
    """
    src = _packed_source(xq, taps_rev, bit_width, history)
    w_parts = band_slice(w_parts, src.m)
    if not xq.is_cuda:
        return _cm2_outputs_plain(src, taps_rev, sat_level, shift, w_parts)
    return _run_cm2(src, taps_rev, sat_level, shift, tile_frames, w_parts)


def channelize_streams_packed_cm(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed ingest -> ``(mag, mag_cm, dph_cm, sat_cm)``.

    The streamed block's front end.  ``mag`` is the time-major (t_len, M)
    magnitude; ``mag_cm`` and ``dph_cm`` are the channel-major (M, t_len)
    streams of :func:`channelize_streams_packed_cm2`, the same bits (one
    kernel body computes both forms); ``sat_cm`` is the (M, t_len) 0/1 mask
    of samples with ``|Re| >= sat_level`` or ``|Im| >= sat_level``, not a
    count.  Arguments as there.
    """
    src = _packed_source(xq, taps_rev, bit_width, history)
    if not xq.is_cuda:
        return _cm_outputs_plain(src, taps_rev, sat_level, shift)
    return _run_cm(src, taps_rev, sat_level, shift, tile_frames)


def channelize_streams_packed(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[torch.Tensor] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed ingest -> time-major ``(mag, phase_deg, sat)``, each
    (t_len, M) f32: the flat form.

    ``mag = |y|``, the same bits as the time-major magnitude of
    :func:`channelize_streams_packed_cm`; ``phase_deg`` the phase itself in
    degrees (the Cephes polynomial of :func:`atan2_cephes`), not its
    difference; ``sat`` the 0/1 mask of samples with ``|Re| >= sat_level`` or
    ``|Im| >= sat_level``.  Arguments as
    :func:`channelize_streams_packed_cm2`; with ``w_parts`` the streams
    have n_bands columns.
    """
    src = _packed_source(xq, taps_rev, bit_width, history)
    w_parts = band_slice(w_parts, src.m)
    if not xq.is_cuda:
        return _flat_plain(src, taps_rev, sat_level, shift, w_parts)
    return _run_flat(src, taps_rev, sat_level, shift, tile_frames, w_parts)


def channelize_streams(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 0,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planes ingest of :func:`channelize_streams_packed`.

    ``xr``, ``xi``: 1-D planes, int16 raw payloads (``bit_width`` set, for
    the dequantization by ``2^-(bit_width-1)``) or float32 already
    normalized (``bit_width=0``).  ``history``: the ``(hist_r, hist_i)``
    pair of (P-1, M) frames before the block, in the planes' dtype.
    ``w_parts`` as in :func:`channelize_streams_packed_cm2`."""
    src = _planes_source(xr, xi, taps_rev, bit_width, history)
    w_parts = band_slice(w_parts, src.m)
    if not xr.is_cuda:
        return _flat_plain(src, taps_rev, sat_level, shift, w_parts)
    return _run_flat(src, taps_rev, sat_level, shift, tile_frames, w_parts)


def channelize_streams_cm(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 0,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planes ingest of :func:`channelize_streams_packed_cm`; planes and
    ``history`` as :func:`channelize_streams`."""
    src = _planes_source(xr, xi, taps_rev, bit_width, history)
    if not xr.is_cuda:
        return _cm_outputs_plain(src, taps_rev, sat_level, shift)
    return _run_cm(src, taps_rev, sat_level, shift, tile_frames)


def channelize_streams_cm2(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 0,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_parts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planes ingest of :func:`channelize_streams_packed_cm2`; planes,
    ``history`` and ``w_parts`` as there and in :func:`channelize_streams`."""
    src = _planes_source(xr, xi, taps_rev, bit_width, history)
    w_parts = band_slice(w_parts, src.m)
    if not xr.is_cuda:
        return _cm2_outputs_plain(src, taps_rev, sat_level, shift, w_parts)
    return _run_cm2(src, taps_rev, sat_level, shift, tile_frames, w_parts)


def channelize_complex(
    x: torch.Tensor,
    taps_rev: np.ndarray,
    shift: bool = True,
    tile_frames: Optional[int] = None,
) -> torch.Tensor:
    """Channelize a 1-D complex64 capture: ``(len(x) // M, M)`` complex64,
    equal to ``channelize(x, chan, method="dft")`` for ``taps_rev =
    chan.taps_rev``.  The capture is read in place, as two float32 planes
    of stride 2; the four real products of the DFT run in the kernel."""
    src = _complex_source(x, taps_rev)
    if not x.is_cuda:
        return torch.complex(*_planes_plain(src, taps_rev, shift))
    return _run_complex(src, taps_rev, shift, tile_frames)


def channelize_complex_planes(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps_rev: np.ndarray,
    shift: bool = True,
    tile_frames: Optional[int] = None,
) -> torch.Tensor:
    """:func:`channelize_complex` from two float32 planes."""
    if xr.dtype != torch.float32:
        raise TypeError("xr and xi must be float32 planes")
    src = _planes_source(xr, xi, taps_rev, 0, None)
    if not xr.is_cuda:
        return torch.complex(*_planes_plain(src, taps_rev, shift))
    return _run_complex(src, taps_rev, shift, tile_frames)
