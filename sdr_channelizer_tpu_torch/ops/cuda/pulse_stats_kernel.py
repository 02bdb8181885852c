"""Kernel K4: per-pulse median magnitude and median phase difference.

The counterpart of ``pulse_stats`` of the JAX package (without the optional
saturation stream: the cm2 route takes saturation from the cumulative
count).  ``pulse_stats`` launches the CUDA selection
(``csrc/pulse_stats.cu``) for CUDA tensors, or raises; for CPU tensors it
takes ``pulse_stats_plain``, a gather of the windows and a sort.

Both give, for a dead slot (``toa`` outside ``[0, t_len)``), 0 in both
outputs, and NaN for a live slot whose range is empty (the phase
difference of a one-sample pulse); callers mask by slot validity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build
from sdr_channelizer_tpu_torch.ops.medians import masked_median

launches = 0  # times the wrapper launched the CUDA kernel

_SMEM_MAX = 227 * 1024


def _check_args(mag_cm, dph_cm, toa, te, window, t_len):
    for name, x in (("mag_cm", mag_cm), ("dph_cm", dph_cm)):
        if x.dtype != torch.float32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor (M, T)")
    if mag_cm.shape != dph_cm.shape:
        raise ValueError("mag_cm and dph_cm must have one shape")
    for name, x in (("toa", toa), ("te", te)):
        if x.dtype != torch.int32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor (M, P_slots)")
    if toa.shape != te.shape or toa.shape[0] > mag_cm.shape[0]:
        raise ValueError("toa and te must share a shape (M, P_slots) with "
                         "M <= the streams' rows")
    if window < 1:
        raise ValueError("window must be >= 1")
    t_len = mag_cm.shape[1] if t_len is None else t_len
    if not 0 <= t_len <= mag_cm.shape[1]:
        raise ValueError(f"t_len={t_len} outside [0, {mag_cm.shape[1]}]")
    return t_len


def pulse_stats_plain(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pulse_stats`."""
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len)
    m, p_slots = toa.shape
    toa_l, te_l = toa.to(torch.int64), te.to(torch.int64)
    live = (toa_l >= 0) & (toa_l < t_len)
    plen = torch.clamp(te_l - toa_l + 1, max=window)
    pos = torch.arange(window, device=toa.device)
    idx = toa_l[..., None] + pos                      # (M, P, window)
    in_any = live[..., None] & (idx < t_len)
    m_mask = in_any & (pos < plen[..., None])
    d_mask = in_any & (pos < plen[..., None] - 1)
    safe = idx.clamp(0, max(mag_cm.shape[1] - 1, 0)).reshape(m, -1)

    def med(stream, mask):
        win = torch.gather(stream[:m], 1, safe).reshape(m, p_slots, window)
        out = masked_median(win, mask, dim=-1)
        return torch.where(live, out, torch.zeros_like(out))

    return med(mag_cm, m_mask), med(dph_cm, d_mask)


def _library():
    import ctypes

    lib = _build.load("pulse_stats")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdr_pulse_stats.argtypes = [
            vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci, ci, vp]
        lib.sdr_pulse_stats.restype = ci
        lib._sdr_typed = True
    return lib


def pulse_stats(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot ``(median magnitude, median phase difference)``, (M, P_slots).

    ``mag_cm`` / ``dph_cm``: (rows >= M, T) channel-major streams; ``toa`` /
    ``te``: (M, P_slots) int32 leading and trailing edge indices, row ``c``
    belonging to channel ``c``.  With ``plen = min(te - toa + 1, window)``
    the magnitude median runs over samples ``toa .. toa + plen - 1`` (the
    trailing edge included) and the phase-difference median over ``toa ..
    toa + plen - 2``, both cut at ``t_len`` (default T).  Any ``window`` that
    fits a block's shared memory (about 58,000 samples) is accepted.
    """
    global launches
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len)
    tensors = (mag_cm, dph_cm, toa, te)
    if not any(x.is_cuda for x in tensors):
        return pulse_stats_plain(mag_cm, dph_cm, toa, te, window, t_len)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all tensors must lie on one CUDA device")
    if mag_cm.stride(1) != 1 or dph_cm.stride() != mag_cm.stride():
        raise ValueError("streams must be contiguous along time, one stride")
    if not (toa.is_contiguous() and te.is_contiguous()):
        raise ValueError("toa and te must be contiguous")
    if window * 4 > _SMEM_MAX:
        raise ValueError(f"window={window} exceeds a block's shared memory")
    m, p_slots = toa.shape
    dev = mag_cm.device
    med_mag = torch.empty((m, p_slots), dtype=torch.float32, device=dev)
    med_dph = torch.empty_like(med_mag)
    if m * p_slots == 0:
        return med_mag, med_dph
    warps = max(1, min(8, (64 * 1024) // (window * 4)))
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.sdr_pulse_stats(
            mag_cm.data_ptr(), dph_cm.data_ptr(), toa.data_ptr(),
            te.data_ptr(), med_mag.data_ptr(), med_dph.data_ptr(),
            mag_cm.stride(0), m, p_slots, window, t_len, warps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "sdr_pulse_stats")
    launches += 1
    return med_mag, med_dph
