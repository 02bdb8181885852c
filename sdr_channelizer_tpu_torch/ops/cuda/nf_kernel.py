"""Kernel K2: exact median of each row, the channel-major noise floor.

The counterpart of ``pallas_noise_floor_cm`` of the JAX package, and the
floor of every fused route and of wideband extraction, where a 1-D
magnitude is one row.  ``noise_floor_cm`` launches the CUDA radix select
(``csrc/noise_floor.cu``: a sample, then passes spread over many blocks a
row, with a candidate buffer between them) for a CUDA tensor, or raises;
for a CPU tensor it takes ``noise_floor_cm_plain``, a sort of the first
``t_len`` columns.  Both give the median a sort gives, bit for bit: the
mean of the order statistics of rank ``(t_len - 1) // 2`` and
``t_len // 2``, NaNs sorting high.
"""

from __future__ import annotations

import torch

from sdr_channelizer_tpu_torch.ops.cuda import _build

launches = 0  # times the wrapper launched the CUDA kernel


def _check_args(mag_cm: torch.Tensor, t_len: int) -> None:
    if mag_cm.dtype != torch.float32 or mag_cm.ndim != 2:
        raise TypeError("mag_cm must be a 2-D float32 tensor (rows, T)")
    if not 0 <= t_len <= mag_cm.shape[1]:
        raise ValueError(f"t_len={t_len} outside [0, {mag_cm.shape[1]}]")


def noise_floor_cm_plain(mag_cm: torch.Tensor, t_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`noise_floor_cm`."""
    _check_args(mag_cm, t_len)
    if t_len == 0:
        return mag_cm.new_full((mag_cm.shape[0],), float("nan"))
    xs, _ = torch.sort(mag_cm[:, :t_len], dim=1)
    return 0.5 * (xs[:, (t_len - 1) // 2] + xs[:, t_len // 2])


def _library():
    import ctypes

    lib = _build.load("noise_floor")
    if not getattr(lib, "_sdr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdr_noise_floor_cm.argtypes = [
            vp, vp, ci, ctypes.c_longlong, ci, vp, vp, ci, vp]
        lib.sdr_noise_floor_cm.restype = ci
        lib.sdr_noise_floor_scratch_words.argtypes = [ci]
        lib.sdr_noise_floor_scratch_words.restype = ctypes.c_longlong
        lib.sdr_noise_floor_cap.argtypes = [ci]
        lib.sdr_noise_floor_cap.restype = ci
        lib._sdr_typed = True
    return lib


def noise_floor_cm(mag_cm: torch.Tensor, t_len: int) -> torch.Tensor:
    """Median of each row of ``mag_cm`` (rows, T) over its first ``t_len``
    columns; columns past ``t_len`` are not read, and rows may lie
    ``stride(0)`` apart (``mag_cm[:m]``; a 1-D tensor as ``x[None]``).
    Returns (rows,) float32, NaN when ``t_len`` is 0 (no launch then)."""
    global launches
    _check_args(mag_cm, t_len)
    if not mag_cm.is_cuda:
        return noise_floor_cm_plain(mag_cm, t_len)
    if mag_cm.stride(1) != 1 or mag_cm.stride(0) < mag_cm.shape[1]:
        raise ValueError("mag_cm rows must be contiguous along time")
    rows = mag_cm.shape[0]
    if rows > 65535 or t_len >= 1 << 31:
        raise ValueError("the select takes at most 65535 rows of < 2^31")
    if rows == 0 or t_len == 0:
        return mag_cm.new_full((rows,), float("nan"))
    dev = mag_cm.device
    out = torch.empty((rows,), dtype=torch.float32, device=dev)
    lib = _library()
    # the histograms and state of each row (the kernel zeroes them) and the
    # candidate buffer between the passes
    scratch = torch.empty(lib.sdr_noise_floor_scratch_words(rows),
                          dtype=torch.int32, device=dev)
    cap = lib.sdr_noise_floor_cap(t_len)
    buf = torch.empty(rows * cap, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.sdr_noise_floor_cm(
            mag_cm.data_ptr(), out.data_ptr(), rows, mag_cm.stride(0), t_len,
            scratch.data_ptr(), buf.data_ptr(), cap,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "sdr_noise_floor_cm")
    launches += 1
    return out
