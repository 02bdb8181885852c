"""The flip kernel: time-major detection streams -> channel-major streams
with the wrapped phase difference.

The counterpart of ``pallas_cm_streams`` of the JAX package.  ``cm_streams``
launches the CUDA kernel (``csrc/transpose.cu``) for CUDA tensors, or
raises; for CPU tensors it takes ``cm_streams_plain``, the plain PyTorch
form of the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

launches = 0  # times cm_streams launched its kernel


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
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdr_cm_streams.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, vp]
        lib.sdr_cm_streams.restype = ci
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
    rounded up to 128 and the time axis rounded up to its block).
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
    mag_cm = torch.empty((m, t_len), dtype=torch.float32, device=mag.device)
    dph_cm = torch.empty_like(mag_cm)
    sat_cm = torch.empty_like(mag_cm)
    if m == 0 or t_len == 0:
        return mag_cm, dph_cm, sat_cm
    lib = _library()
    with torch.cuda.device(mag.device):
        code = lib.sdr_cm_streams(
            mag.data_ptr(), ph.data_ptr(), sat.data_ptr(), sat.element_size(),
            mag_cm.data_ptr(), dph_cm.data_ptr(), sat_cm.data_ptr(), m, t_len,
            torch.cuda.current_stream(mag.device).cuda_stream)
    _build.check_launch(code, "sdr_cm_streams")
    launches += 1
    return mag_cm, dph_cm, sat_cm
