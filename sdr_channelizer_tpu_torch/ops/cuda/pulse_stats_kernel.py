"""Kernel K4: per-pulse median magnitude, median phase difference and,
with a saturation mask, the saturated flag.

The counterparts of ``pulse_stats`` (a slot grid, row = channel) and
``pulse_stats_dense`` (a flat slot list with a channel per slot) of the JAX
package.  Both launch the CUDA selection (``csrc/pulse_stats.cu``) for CUDA
tensors, or raise; for CPU tensors they take ``pulse_stats_plain`` /
``pulse_stats_dense_plain``, a gather of the windows and a sort.

All give, for a dead slot (``toa`` outside ``[0, t_len)``), 0 in every
output, and NaN for a live slot whose range is empty (the phase
difference of a one-sample pulse); callers mask by slot validity.  The
saturated flag is 1.0 where a sample strictly inside the pulse, ``toa + 1
.. toa + plen - 2`` cut at ``t_len``, is saturated, else 0.0; the cm2 route
passes no mask and takes saturation from its cumulative count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build
from sdr_channelizer_tpu_torch.ops.medians import masked_median

launches = 0        # times pulse_stats launched the CUDA kernel
launches_dense = 0  # times pulse_stats_dense launched it

_SMEM_MAX = 227 * 1024


def _check_streams(mag_cm, dph_cm, sat_cm, window, t_len):
    for name, x in (("mag_cm", mag_cm), ("dph_cm", dph_cm),
                    ("sat_cm", sat_cm)):
        if x is None and name == "sat_cm":
            continue
        if x.dtype != torch.float32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor (M, T)")
        if x.shape != mag_cm.shape:
            raise ValueError("the streams must have one shape")
    if window < 1:
        raise ValueError("window must be >= 1")
    t_len = mag_cm.shape[1] if t_len is None else t_len
    if not 0 <= t_len <= mag_cm.shape[1]:
        raise ValueError(f"t_len={t_len} outside [0, {mag_cm.shape[1]}]")
    return t_len


def _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm=None):
    t_len = _check_streams(mag_cm, dph_cm, sat_cm, window, t_len)
    for name, x in (("toa", toa), ("te", te)):
        if x.dtype != torch.int32 or x.ndim != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor (M, P_slots)")
    if toa.shape != te.shape or toa.shape[0] > mag_cm.shape[0]:
        raise ValueError("toa and te must share a shape (M, P_slots) with "
                         "M <= the streams' rows")
    return t_len


def _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window, t_len):
    t_len = _check_streams(mag_cm, dph_cm, sat_cm, window, t_len)
    for name, x in (("toa", toa), ("te", te), ("chan", chan)):
        if x.dtype != torch.int32 or x.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor (P,)")
    if not toa.shape == te.shape == chan.shape:
        raise ValueError("toa, te and chan must share a shape (P,)")
    return t_len


def _stats_plain(mag_cm, dph_cm, sat_cm, toa, te, rows, window, t_len):
    """Medians (and the flag) of flat slots: ``rows`` is each slot's row of
    the streams.  Slots are gathered as (P, window) windows."""
    toa_l, te_l = toa.to(torch.int64), te.to(torch.int64)
    live = (toa_l >= 0) & (toa_l < t_len)
    plen = torch.clamp(te_l - toa_l + 1, max=window)
    pos = torch.arange(window, device=toa.device)
    idx = toa_l[:, None] + pos                        # (P, window)
    in_any = live[:, None] & (idx < t_len)
    m_mask = in_any & (pos < plen[:, None])
    d_mask = in_any & (pos < plen[:, None] - 1)
    t_arr = mag_cm.shape[1]
    flat = rows.to(torch.int64)[:, None] * t_arr + idx.clamp(0, max(t_arr - 1, 0))

    def win(stream):
        return stream.reshape(-1)[flat]

    def med(stream, mask):
        out = masked_median(win(stream), mask, dim=-1)
        return torch.where(live, out, torch.zeros_like(out))

    outs = (med(mag_cm, m_mask), med(dph_cm, d_mask))
    if sat_cm is None:
        return outs
    hit = ((win(sat_cm) > 0.5) & d_mask & (pos >= 1)).any(-1)
    return outs + (hit.to(torch.float32),)


def pulse_stats_plain(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    sat_cm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`pulse_stats`."""
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm)
    m, p_slots = toa.shape
    rows = torch.arange(m, device=toa.device).repeat_interleave(p_slots)
    outs = _stats_plain(mag_cm, dph_cm, sat_cm, toa.reshape(-1),
                        te.reshape(-1), rows, window, t_len)
    return tuple(o.reshape(m, p_slots) for o in outs)


def pulse_stats_dense_plain(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    sat_cm: Optional[torch.Tensor],
    toa: torch.Tensor,
    te: torch.Tensor,
    chan: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`pulse_stats_dense`."""
    t_len = _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window,
                              t_len)
    return _stats_plain(mag_cm, dph_cm, sat_cm, toa, te, chan, window, t_len)


def _library():
    import ctypes

    lib = _build.load("pulse_stats")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdr_pulse_stats.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci,
            ci, ci, vp]
        lib.sdr_pulse_stats.restype = ci
        lib._sdr_typed = True
    return lib


def _launch(mag_cm, dph_cm, sat_cm, toa, te, chan, p_slots, window, t_len):
    """Checks shared by both wrappers, then the kernel over ``toa.numel()``
    slots; outputs in the shape of ``toa``."""
    global launches, launches_dense
    streams = [x for x in (mag_cm, dph_cm, sat_cm) if x is not None]
    indices = [x for x in (toa, te, chan) if x is not None]
    if len({x.device for x in streams + indices}) != 1 or not mag_cm.is_cuda:
        raise ValueError("all tensors must lie on one CUDA device")
    if mag_cm.stride(1) != 1 or any(x.stride() != mag_cm.stride()
                                    for x in streams):
        raise ValueError("streams must be contiguous along time, one stride")
    if not all(x.is_contiguous() for x in indices):
        raise ValueError("toa, te and chan must be contiguous")
    if window * 4 > _SMEM_MAX:
        raise ValueError(f"window={window} exceeds a block's shared memory")
    dev = mag_cm.device
    outs = tuple(torch.empty(toa.shape, dtype=torch.float32, device=dev)
                 for _ in range(2 if sat_cm is None else 3))
    if toa.numel() == 0:
        return outs
    warps = max(1, min(8, (64 * 1024) // (window * 4)))
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.sdr_pulse_stats(
            mag_cm.data_ptr(), dph_cm.data_ptr(),
            None if sat_cm is None else sat_cm.data_ptr(), toa.data_ptr(),
            te.data_ptr(), None if chan is None else chan.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            None if sat_cm is None else outs[2].data_ptr(),
            mag_cm.stride(0), toa.numel(), p_slots, window, t_len, warps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "sdr_pulse_stats")
    if chan is None:
        launches += 1
    else:
        launches_dense += 1
    return outs


def pulse_stats(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    toa: torch.Tensor,
    te: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
    sat_cm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Per-slot ``(median magnitude, median phase difference)``, (M, P_slots),
    and with ``sat_cm`` a third tensor, the saturated flag.

    ``mag_cm`` / ``dph_cm``: (rows >= M, T) channel-major streams; ``toa`` /
    ``te``: (M, P_slots) int32 leading and trailing edge indices, row ``c``
    belonging to channel ``c``.  With ``plen = min(te - toa + 1, window)``
    the magnitude median runs over samples ``toa .. toa + plen - 1`` (the
    trailing edge included) and the phase-difference median over ``toa ..
    toa + plen - 2``, both cut at ``t_len`` (default T).  ``sat_cm``: the
    (rows, T) 0/1 saturation mask; the flag is 1.0 where a sample of ``toa +
    1 .. toa + plen - 2`` (cut at ``t_len``) is saturated.  Any ``window``
    that fits a block's shared memory (about 58,000 samples) is accepted.
    """
    t_len = _check_args(mag_cm, dph_cm, toa, te, window, t_len, sat_cm)
    tensors = [x for x in (mag_cm, dph_cm, sat_cm, toa, te) if x is not None]
    if not any(x.is_cuda for x in tensors):
        return pulse_stats_plain(mag_cm, dph_cm, toa, te, window, t_len,
                                 sat_cm)
    return _launch(mag_cm, dph_cm, sat_cm, toa, te, None, toa.shape[1],
                   window, t_len)


def pulse_stats_dense(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    sat_cm: Optional[torch.Tensor],
    toa: torch.Tensor,
    te: torch.Tensor,
    chan: torch.Tensor,
    window: int,
    t_len: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """The statistics of :func:`pulse_stats` over one flat slot list that
    mixes channels: ``toa``, ``te``, ``chan`` are (P,) int32, ``chan`` the
    row of the streams each slot reads; outputs are (P,).  ``sat_cm`` may be
    ``None`` (then two outputs)."""
    t_len = _check_args_dense(mag_cm, dph_cm, sat_cm, toa, te, chan, window,
                              t_len)
    tensors = [x for x in (mag_cm, dph_cm, sat_cm, toa, te, chan)
               if x is not None]
    if not any(x.is_cuda for x in tensors):
        return pulse_stats_dense_plain(mag_cm, dph_cm, sat_cm, toa, te, chan,
                                       window, t_len)
    return _launch(mag_cm, dph_cm, sat_cm, toa, te, chan, 0, window, t_len)
