"""The flip kernel: time-major detection streams -> channel-major streams
with the wrapped phase difference; and its one-channel form fed straight
from a wideband capture.

The counterpart of ``pallas_cm_streams`` of the JAX package.  ``cm_streams``
launches the CUDA kernel (``csrc/transpose.cu``) for CUDA tensors, or
raises; for CPU tensors it takes ``cm_streams_plain``, the plain PyTorch
form of the same function.  ``wideband_streams`` makes the one-channel
streams ``(mag, dph_cm, sat_cm)`` from a complex64 capture in one pass; its
plain version is the detection streams of :func:`prep_streams` flipped by
``cm_streams_plain``, and the kernel gives the same bits.

The C entries pick each kernel's variant from the pointers and M: 16-byte
loads where the streams allow them, 4-byte ones otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

launches = 0            # times cm_streams launched its kernel
launches_wideband = 0   # times wideband_streams launched its kernel

# the float32 degrees per radian the phase stream is scaled by
RAD2DEG = float(np.float32(180.0 / np.pi))


def prep_streams(iq: torch.Tensor, saturation_level: float):
    """The detection streams of a complex capture: magnitude, phase in
    degrees and the saturation mask (``|Re|`` or ``|Im|`` at the level)."""
    mag = iq.abs()
    phase_deg = torch.angle(iq) * RAD2DEG
    sat = ((iq.real.abs() >= saturation_level)
           | (iq.imag.abs() >= saturation_level))
    return mag, phase_deg, sat


def _check_args(mag, ph, sat):
    if mag.ndim != 2 or mag.dtype != torch.float32 \
            or ph.dtype != torch.float32:
        raise TypeError("mag and ph must be 2-D float32 tensors (T, M)")
    if ph.shape != mag.shape or sat.shape != mag.shape:
        raise ValueError("mag, ph and sat must have one shape (T, M)")
    if sat.dtype not in (torch.float32, torch.bool):
        raise TypeError("sat must be a bool or a 0/1 float32 mask")
    if ph.device != mag.device or sat.device != mag.device:
        raise ValueError("mag, ph and sat must lie on one device")


def cm_streams_plain(
    mag: torch.Tensor, ph: torch.Tensor, sat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cm_streams`."""
    _check_args(mag, ph, sat)
    t_len, m = mag.shape
    d = ph[1:] - ph[:-1]
    d = torch.where(d < -180.0, d + 360.0, d)
    d = torch.where(d > 180.0, d - 360.0, d)  # strict: exactly +-180 stays
    dph = torch.cat([d, d.new_zeros((min(t_len, 1), m))], dim=0)
    return (mag.T.contiguous(), dph.T.contiguous(),
            sat.to(torch.float32).T.contiguous())


def _library():
    import ctypes

    lib = _build.load("transpose")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci, cf, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_longlong)
        lib.sdr_cm_streams.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, vp]
        lib.sdr_cm_streams.restype = ci
        lib.sdr_wideband_streams.argtypes = [vp, cf, cf, vp, vp, vp, cll, vp]
        lib.sdr_wideband_streams.restype = ci
        lib._sdr_typed = True
    return lib


def cm_streams(
    mag: torch.Tensor, ph: torch.Tensor, sat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mag, ph, sat)`` time-major (T, M) -> ``(mag_cm, dph_cm, sat_cm)``
    channel-major (M, T) float32.

    ``ph`` is the phase in degrees; ``sat`` a bool or 0/1 float32 mask.
    ``mag_cm`` and ``sat_cm`` are the flips, bit for bit; ``dph_cm[:, t]`` is
    the phase step from frame ``t`` to ``t + 1``, wrapped once into
    [-180, 180] with strict inequalities, and zero at column ``T - 1``.  The
    outputs have exactly M rows and T columns (the JAX kernel's have M
    rounded up to 128 and the time axis rounded up to its block).  At M = 1
    ``mag_cm`` and a float mask's ``sat_cm`` are views of the inputs, as
    the plain version's are.
    """
    global launches
    _check_args(mag, ph, sat)
    if not mag.is_cuda:
        return cm_streams_plain(mag, ph, sat)
    if not (mag.is_contiguous() and ph.is_contiguous()
            and sat.is_contiguous()):
        raise ValueError("mag, ph and sat must be contiguous")
    t_len, m = mag.shape
    if t_len >= 1 << 31:
        raise ValueError("T must be < 2^31")
    dph_cm = torch.empty((m, t_len), dtype=torch.float32, device=mag.device)
    if m == 1:   # views, with the row stride of a fresh (1, T) tensor
        mag_cm = mag.view(1, t_len)
        sat_cm = sat.view(1, t_len) if sat.dtype == torch.float32 else \
            torch.empty_like(dph_cm)
    else:
        mag_cm, sat_cm = torch.empty_like(dph_cm), torch.empty_like(dph_cm)
    if m == 0 or t_len == 0:
        return mag_cm, dph_cm, sat_cm
    lib = _library()
    bool_sat = sat.dtype == torch.bool
    with torch.cuda.device(mag.device):
        code = lib.sdr_cm_streams(
            mag.data_ptr(), ph.data_ptr(), sat.data_ptr(), sat.element_size(),
            None if m == 1 else mag_cm.data_ptr(), dph_cm.data_ptr(),
            sat_cm.data_ptr() if m > 1 or bool_sat else None, m, t_len,
            torch.cuda.current_stream(mag.device).cuda_stream)
    _build.check_launch(code, "sdr_cm_streams")
    launches += 1
    return mag_cm, dph_cm, sat_cm


def wideband_streams_plain(
    x: torch.Tensor, saturation_level: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`wideband_streams`."""
    _check_capture(x)
    mag, ph, sat = prep_streams(x, saturation_level)
    _, dph_cm, sat_cm = cm_streams_plain(mag[:, None], ph[:, None],
                                         sat[:, None])
    t_len = mag.shape[0]   # the (1, T) rows with the strides of the kernel's
    return mag, dph_cm.view(1, t_len), sat_cm.view(1, t_len)


def _check_capture(x):
    if x.ndim != 1 or x.dtype != torch.complex64:
        raise TypeError("x must be a 1-D complex64 capture")


def wideband_streams(
    x: torch.Tensor, saturation_level: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A (T,) complex64 capture -> ``(mag (T,), dph_cm (1, T), sat_cm (1,
    T))`` float32: the one-channel streams of :func:`cm_streams`, made in
    one pass from the capture.  ``mag`` is also ``mag_cm`` (``mag[None]``);
    ``sat_cm`` is the 0/1 mask ``|Re| >= level or |Im| >= level``."""
    global launches_wideband
    _check_capture(x)
    if not x.is_cuda:
        return wideband_streams_plain(x, saturation_level)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    t_len = x.shape[0]
    mag = torch.empty((t_len,), dtype=torch.float32, device=x.device)
    dph_cm = torch.empty((1, t_len), dtype=torch.float32, device=x.device)
    sat_cm = torch.empty_like(dph_cm)
    if t_len == 0:
        return mag, dph_cm, sat_cm
    with torch.cuda.device(x.device):
        code = _library().sdr_wideband_streams(
            x.data_ptr(), float(saturation_level), RAD2DEG, mag.data_ptr(),
            dph_cm.data_ptr(), sat_cm.data_ptr(), t_len,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(code, "sdr_wideband_streams")
    launches_wideband += 1
    return mag, dph_cm, sat_cm

