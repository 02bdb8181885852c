"""Kernel K3 and its time-major form: the hysteresis latch and the edge
cumulative counts.

The counterparts of ``pallas_latch_cumsums_cm`` (channel-major magnitude in)
and ``pallas_latch_cumsums`` (time-major magnitude in) of the JAX package.
``latch_cumsums_cm`` and ``latch_cumsums`` launch the CUDA scan
(``csrc/latch.cu``, one kernel for both layouts) for a CUDA tensor, or
raise; for a CPU tensor they take ``latch_cumsums_cm_plain`` and
``latch_cumsums_plain``.  The scan runs over segments of time in parallel
and chains each row's segments by decoupled look-back; its status words are
allocated, zeroed, for each call.

The latch follows the kernel's three-state rule: a sample's transfer is
``(mag >= lead) - (mag <= trail)`` (+1 set, -1 reset, 0 hold), so a sample
that meets both thresholds at once (``lead == trail == mag``) holds the
state; it does not toggle it.
"""

from __future__ import annotations

from typing import Optional

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

launches = 0     # times latch_cumsums_cm launched its kernel
launches_tm = 0  # times latch_cumsums launched its kernel


def _check_args(mag_cm, lead_thresh, trail_thresh, m_real, entry_active):
    if mag_cm.dtype != torch.float32 or mag_cm.ndim != 2:
        raise TypeError("mag_cm must be a 2-D float32 tensor (R, T)")
    r = mag_cm.shape[0]
    m_real = r if m_real is None else m_real
    if not 0 <= m_real <= r or lead_thresh.shape != (m_real,) \
            or trail_thresh.shape != (m_real,):
        raise ValueError("thresholds must have shape (m_real,), m_real <= R")
    if entry_active is not None and entry_active.shape != (m_real,):
        raise ValueError("entry_active must have shape (m_real,)")
    return m_real


def _column(mag_cm, v, m_real, fill):
    c = mag_cm.new_full((mag_cm.shape[0],), fill)
    c[:m_real] = v.to(device=mag_cm.device, dtype=torch.float32)
    return c


def latch_cumsums_cm_plain(
    mag_cm: torch.Tensor,
    lead_thresh: torch.Tensor,
    trail_thresh: torch.Tensor,
    m_real: Optional[int] = None,
    entry_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`latch_cumsums_cm`.

    The state after sample ``t`` is the sign of the last non-hold transfer
    at or before ``t``, else the entry state: a running maximum over the
    positions of the non-hold transfers finds it without a scan."""
    m_real = _check_args(mag_cm, lead_thresh, trail_thresh, m_real,
                         entry_active)
    # rows past m_real get +inf thresholds: they reset always, never open
    lead = _column(mag_cm, lead_thresh, m_real, float("inf"))
    trail = _column(mag_cm, trail_thresh, m_real, float("inf"))
    entry = (mag_cm.new_zeros((mag_cm.shape[0],)) if entry_active is None
             else _column(mag_cm, entry_active, m_real, 0.0))
    r, t_len = mag_cm.shape
    tr = ((mag_cm >= lead[:, None]).to(torch.int8)
          - (mag_cm <= trail[:, None]).to(torch.int8))
    pos = torch.arange(t_len, device=mag_cm.device)
    last = torch.cummax(
        torch.where(tr != 0, pos, torch.full_like(pos, -1)), dim=1).values
    picked = torch.gather(tr, 1, last.clamp(min=0)) > 0
    entry_b = entry[:, None] > 0.5
    state = torch.where(last >= 0, picked, entry_b)
    prev = torch.cat([entry_b, state[:, :-1]], dim=1)
    lead_edge = state & ~prev
    trail_edge = prev & ~state
    edges = torch.cat([lead_edge, trail_edge], dim=0)
    return torch.cumsum(edges.to(torch.int32), dim=1).to(torch.float32)


def _library():
    import ctypes

    lib = _build.load("latch")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdr_latch_cumsums_cm.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.sdr_latch_cumsums_cm.restype = ci
        lib.sdr_latch_cumsums_tm.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, vp]
        lib.sdr_latch_cumsums_tm.restype = ci
        for fn in (lib.sdr_latch_tm_scratch_words,
                   lib.sdr_latch_cm_scratch_words):
            fn.argtypes = [ci, ci]
            fn.restype = ctypes.c_longlong
        lib._sdr_typed = True
    return lib


def latch_cumsums_cm(
    mag_cm: torch.Tensor,
    lead_thresh: torch.Tensor,
    trail_thresh: torch.Tensor,
    m_real: Optional[int] = None,
    entry_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge cumulative counts of the per-row latch over ``mag_cm`` (R, T).

    ``lead_thresh`` / ``trail_thresh``: (m_real,) absolute thresholds of the
    first ``m_real`` rows (default all R); further rows never open.
    ``entry_active``: (m_real,) state in which each latch enters (default
    inactive).  Returns one (2R, T) float32 tensor: rows [0, R) the
    inclusive count of leading edges, rows [R, 2R) that of trailing edges.
    A pulse still open at column T - 1 gets no trailing edge.
    """
    global launches
    m_real = _check_args(mag_cm, lead_thresh, trail_thresh, m_real,
                         entry_active)
    if not mag_cm.is_cuda:
        return latch_cumsums_cm_plain(mag_cm, lead_thresh, trail_thresh,
                                      m_real, entry_active)
    if not mag_cm.is_contiguous():
        raise ValueError("mag_cm must be contiguous")
    r, t_len = mag_cm.shape
    if t_len >= 1 << 24:
        raise ValueError("edge counts are float32: T must be < 2^24")
    out = torch.empty((2 * r, t_len), dtype=torch.float32,
                      device=mag_cm.device)
    if r == 0 or t_len == 0:
        return out

    def on_device(v):
        return v.to(device=mag_cm.device, dtype=torch.float32).contiguous()

    lead, trail = on_device(lead_thresh), on_device(trail_thresh)
    entry = None if entry_active is None else on_device(entry_active)
    lib = _library()
    # the segments' ticket and status words, zeroed for each call
    scratch = torch.zeros(lib.sdr_latch_cm_scratch_words(r, t_len),
                          dtype=torch.int64, device=mag_cm.device)
    with torch.cuda.device(mag_cm.device):
        code = lib.sdr_latch_cumsums_cm(
            mag_cm.data_ptr(), lead.data_ptr(), trail.data_ptr(),
            None if entry is None else entry.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), r, m_real, t_len,
            torch.cuda.current_stream(mag_cm.device).cuda_stream)
    _build.check_launch(code, "sdr_latch_cumsums_cm")
    launches += 1
    return out


def _check_args_tm(mag, lead_thresh, trail_thresh, entry_active):
    if mag.dtype != torch.float32 or mag.ndim != 2:
        raise TypeError("mag must be a 2-D float32 tensor (T, M)")
    m = mag.shape[1]
    if lead_thresh.shape != (m,) or trail_thresh.shape != (m,):
        raise ValueError("thresholds must have shape (M,)")
    if entry_active is not None and entry_active.shape != (m,):
        raise ValueError("entry_active must have shape (M,)")


def latch_cumsums_plain(
    mag: torch.Tensor,
    lead_thresh: torch.Tensor,
    trail_thresh: torch.Tensor,
    entry_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`latch_cumsums`: the channel-major
    plain version on the flipped magnitude."""
    _check_args_tm(mag, lead_thresh, trail_thresh, entry_active)
    return latch_cumsums_cm_plain(mag.T.contiguous(), lead_thresh,
                                  trail_thresh, None, entry_active)


def latch_cumsums(
    mag: torch.Tensor,
    lead_thresh: torch.Tensor,
    trail_thresh: torch.Tensor,
    entry_active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Edge cumulative counts of the per-channel latch over the time-major
    magnitude ``mag`` (T, M).

    ``lead_thresh`` / ``trail_thresh``: (M,) absolute thresholds;
    ``entry_active``: (M,) state in which each latch enters (default
    inactive).  Returns one (2M, T) float32 tensor in the layout of
    :func:`latch_cumsums_cm`: rows [0, M) the inclusive count of leading
    edges per channel, rows [M, 2M) that of trailing edges, so one rank
    search finds every edge.  There are no pad columns: a pulse still open
    at frame T - 1 gets no trailing edge, and the rank search answers it with
    its sentinel T.
    """
    global launches_tm
    _check_args_tm(mag, lead_thresh, trail_thresh, entry_active)
    if not mag.is_cuda:
        return latch_cumsums_plain(mag, lead_thresh, trail_thresh,
                                   entry_active)
    if not mag.is_contiguous():
        raise ValueError("mag must be contiguous")
    t_len, m = mag.shape
    if t_len >= 1 << 24:
        raise ValueError("edge counts are float32: T must be < 2^24")
    out = torch.empty((2 * m, t_len), dtype=torch.float32, device=mag.device)
    if m == 0 or t_len == 0:
        return out

    def on_device(v):
        return v.to(device=mag.device, dtype=torch.float32).contiguous()

    lead, trail = on_device(lead_thresh), on_device(trail_thresh)
    entry = None if entry_active is None else on_device(entry_active)
    lib = _library()
    # the segments' ticket and status words, zeroed for each call
    scratch = torch.zeros(lib.sdr_latch_tm_scratch_words(m, t_len),
                          dtype=torch.int64, device=mag.device)
    with torch.cuda.device(mag.device):
        code = lib.sdr_latch_cumsums_tm(
            mag.data_ptr(), lead.data_ptr(), trail.data_ptr(),
            None if entry is None else entry.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), m, t_len,
            torch.cuda.current_stream(mag.device).cuda_stream)
    _build.check_launch(code, "sdr_latch_cumsums_tm")
    launches_tm += 1
    return out
