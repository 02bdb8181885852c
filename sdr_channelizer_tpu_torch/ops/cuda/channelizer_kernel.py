"""Kernel K1 and its cm mode: packed capture -> detection streams.

The counterparts of ``pallas_channelize_streams_packed_cm2`` and
``pallas_channelize_streams_packed_cm`` of the JAX package: sign-extend and
dequantize the packed (I, Q) pairs, the polyphase branch FIR over the
``history`` frames of the previous block (zeros by default), the
shift-folded DFT in full float32, then the channel-major streams of the PDW
front end.  The cm2 form gives the saturation as a cumulative count; the cm
form gives it as a 0/1 mask and adds the time-major magnitude that the
streamed noise floor and the time-major latch read.

``channelize_streams_packed_cm2`` / ``channelize_streams_packed_cm`` launch
the CUDA kernel (``csrc/channelizer.cu``, one body for both) for a CUDA
tensor, or raise; for a CPU tensor they take their ``_plain`` versions, the
plain PyTorch form of the same functions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

launches = 0     # times channelize_streams_packed_cm2 launched its kernel
launches_cm = 0  # times channelize_streams_packed_cm launched its kernel

_PACKED = {torch.int32: 4, torch.int16: 2}
_TILE_FRAMES = (64, 32, 16, 8, 4)
_SMEM_TARGET = 100 * 1024   # two blocks a multiprocessor
_SMEM_MAX = 227 * 1024      # what one block may use on sm_90

_weights = {}  # (device, shift, taps bytes) -> (taps, wr, wi) on the device


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


def channelize_planes_plain(xq: torch.Tensor, taps_rev, bit_width: int,
                            shift: bool = True,
                            history: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (T, M) real and imaginary planes of the channelizer output, from
    the packed capture, in plain PyTorch (matmul in full float32)."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import (
        dft_matrix,
        fir_branches,
    )

    p, m, t_len = _check_args(xq, taps_rev)
    scale = float(2.0 ** -(bit_width - 1))
    vi, vq = unpack_pairs(xq[: t_len * m])
    taps = torch.as_tensor(np.asarray(taps_rev, np.float32), device=xq.device)
    hist = _check_history(history, xq, p, m)
    hi = hq = None
    if hist is not None:
        hi, hq = ((h * scale).reshape(p - 1, m) for h in unpack_pairs(hist))
    ur = fir_branches((vi * scale).reshape(t_len, m), taps, hi)
    ui = fir_branches((vq * scale).reshape(t_len, m), taps, hq)
    w = dft_matrix(m, shifted=shift)
    wr = torch.as_tensor(np.ascontiguousarray(w.real), device=xq.device)
    wi = torch.as_tensor(np.ascontiguousarray(w.imag), device=xq.device)
    if xq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain version needs full-float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    yr = ur @ wr - ui @ wi
    yi = ur @ wi + ui @ wr
    return yr, yi


def _streams_plain(xq, taps_rev, bit_width, sat_level, shift, history):
    """Time-major (T, M) ``(mag, dph, sat)`` shared by both plain forms."""
    yr, yi = channelize_planes_plain(xq, taps_rev, bit_width, shift, history)
    t_len, m = yr.shape
    mag = torch.sqrt(yr * yr + yi * yi)
    ph = atan2_cephes(yi, yr) * float(np.float32(180.0 / np.pi))
    sat = ((yr.abs() >= sat_level) | (yi.abs() >= sat_level)).to(torch.float32)
    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)  # strict: exactly +-180 stays
    dph = torch.cat([d, d.new_zeros((min(t_len, 1), m))], dim=0)
    return mag, dph, sat


def channelize_streams_packed_cm2_plain(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    history: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`channelize_streams_packed_cm2`."""
    mag, dph, sat = _streams_plain(xq, taps_rev, bit_width, sat_level, shift,
                                   history)
    return (mag.T.contiguous(), dph.T.contiguous(),
            torch.cumsum(sat, dim=0).T.contiguous())


def channelize_streams_packed_cm_plain(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    history: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`channelize_streams_packed_cm`."""
    mag, dph, sat = _streams_plain(xq, taps_rev, bit_width, sat_level, shift,
                                   history)
    return (mag, mag.T.contiguous(), dph.T.contiguous(), sat.T.contiguous())


def _tile_frames(lib, m: int, p: int) -> int:
    for cap in (_SMEM_TARGET, _SMEM_MAX):
        for ft in _TILE_FRAMES:
            if lib.sdr_channelize_cm2_smem(m, p, ft) <= cap:
                return ft
    raise ValueError(
        f"channelizer kernel: M={m} bands with P={p} taps per band do not fit "
        f"one block's shared memory")


def _device_weights(taps_rev, shift: bool, dev, mp: int):
    """The taps and the DFT planes (rows padded to ``mp`` columns) on the
    device, kept from call to call: set-up, not part of a step."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import dft_matrix

    taps = np.ascontiguousarray(taps_rev, np.float32)
    key = (dev, shift, taps.shape, taps.tobytes())
    hit = _weights.get(key)
    if hit is None:
        m = taps.shape[1]
        w = dft_matrix(m, shifted=shift)
        wr = np.zeros((m, mp), np.float32)
        wi = np.zeros((m, mp), np.float32)
        wr[:, :m], wi[:, :m] = w.real, w.imag
        if len(_weights) >= 16:
            _weights.clear()
        hit = tuple(torch.as_tensor(a, device=dev) for a in (taps, wr, wi))
        _weights[key] = hit
    return hit


def _library():
    import ctypes

    lib = _build.load("channelizer")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdr_channelize_cm2.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf,
            cf, vp]
        lib.sdr_channelize_cm2.restype = ci
        lib.sdr_channelize_cm.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf,
            cf, vp]
        lib.sdr_channelize_cm.restype = ci
        lib.sdr_channelize_cm2_smem.argtypes = [ci, ci, ci]
        lib.sdr_channelize_cm2_smem.restype = ctypes.c_longlong
        lib._sdr_typed = True
    return lib


def _launch_plan(xq, taps_rev, shift, tile_frames):
    """What both kernel forms share before the launch: the library, the
    weights on the device and the tile length."""
    p, m, t_len = _check_args(xq, taps_rev)
    mp = (m + 3) // 4 * 4
    weights = _device_weights(taps_rev, shift, xq.device, mp)
    lib = _library()
    ft = tile_frames or _tile_frames(lib, m, p)
    if ft % 4 or lib.sdr_channelize_cm2_smem(m, p, ft) > _SMEM_MAX:
        raise ValueError(f"tile_frames={ft} must be a multiple of 4 that fits "
                         f"shared memory")
    return lib, weights, mp, ft


def channelize_streams_packed_cm2(
    xq: torch.Tensor,
    taps_rev: np.ndarray,
    bit_width: int = 12,
    sat_level: float = 0.9999,
    shift: bool = True,
    tile_frames: Optional[int] = None,
    history: Optional[torch.Tensor] = None,
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
    axis rounded up to its block).  The DFT is computed with plain float32
    fused multiply-adds, never TF32.
    """
    global launches
    p, m, t_len = _check_args(xq, taps_rev)
    hist = _check_history(history, xq, p, m)
    if not xq.is_cuda:
        return channelize_streams_packed_cm2_plain(
            xq, taps_rev, bit_width, sat_level, shift, hist)
    if t_len >= 1 << 24:
        raise ValueError("satcs_cm counts are float32: t_len must be < 2^24")
    dev = xq.device
    mag = torch.empty((m, t_len), dtype=torch.float32, device=dev)
    dph = torch.empty_like(mag)
    satcs = torch.empty_like(mag)
    if t_len == 0:
        return mag, dph, satcs
    lib, (taps_d, wr_d, wi_d), mp, ft = _launch_plan(xq, taps_rev, shift,
                                                     tile_frames)
    n_tiles = (t_len + ft - 1) // ft
    tile_tot = torch.empty((m, n_tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.sdr_channelize_cm2(
            xq.data_ptr(), _PACKED[xq.dtype],
            None if hist is None else hist.data_ptr(), taps_d.data_ptr(),
            wr_d.data_ptr(), wi_d.data_ptr(), mag.data_ptr(), dph.data_ptr(),
            satcs.data_ptr(), tile_tot.data_ptr(), m, mp, p, t_len, ft,
            float(2.0 ** -(bit_width - 1)), float(sat_level),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "sdr_channelize_cm2")
    launches += 1
    return mag, dph, satcs


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
    global launches_cm
    p, m, t_len = _check_args(xq, taps_rev)
    hist = _check_history(history, xq, p, m)
    if not xq.is_cuda:
        return channelize_streams_packed_cm_plain(
            xq, taps_rev, bit_width, sat_level, shift, hist)
    dev = xq.device
    mag_tm = torch.empty((t_len, m), dtype=torch.float32, device=dev)
    mag = torch.empty((m, t_len), dtype=torch.float32, device=dev)
    dph = torch.empty_like(mag)
    sat = torch.empty_like(mag)
    if t_len == 0:
        return mag_tm, mag, dph, sat
    lib, (taps_d, wr_d, wi_d), mp, ft = _launch_plan(xq, taps_rev, shift,
                                                     tile_frames)
    with torch.cuda.device(dev):
        code = lib.sdr_channelize_cm(
            xq.data_ptr(), _PACKED[xq.dtype],
            None if hist is None else hist.data_ptr(), taps_d.data_ptr(),
            wr_d.data_ptr(), wi_d.data_ptr(), mag_tm.data_ptr(),
            mag.data_ptr(), dph.data_ptr(), sat.data_ptr(), m, mp, p, t_len,
            ft, float(2.0 ** -(bit_width - 1)), float(sat_level),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "sdr_channelize_cm")
    launches_cm += 1
    return mag_tm, mag, dph, sat
