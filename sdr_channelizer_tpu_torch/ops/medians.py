"""Exact median reductions, MATLAB semantics: the middle element for odd
counts, the mean of the two middle elements for even counts, NaN for an
empty mask; NaNs sort high.

Sort-based, which is exact and is all the plain PyTorch code needs.  The
order-preserving u32 key maps are here because the CUDA kernels select on
those keys and their plain versions state the same order.
"""

from __future__ import annotations

from typing import Optional

import torch


def sortable_u32(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 f32 -> keys with the same total order (NaNs sort high).

    Returned as int64 holding the u32 value (torch has no full u32
    arithmetic)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (u >> 31) == 1
    return torch.where(neg, (~u) & 0xFFFFFFFF, u | 0x80000000)


def u32_to_f32(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sortable_u32`."""
    neg = (keys >> 31) == 0  # originally negative: sign bit now clear
    raw = torch.where(neg, (~keys) & 0xFFFFFFFF, keys & 0x7FFFFFFF)
    raw = torch.where(raw >= 0x80000000, raw - 0x100000000, raw)
    return raw.to(torch.int32).view(torch.float32)


def masked_median(x: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median of ``x`` where ``mask`` is True along ``dim``; NaN where the
    mask is empty."""
    mask = mask.expand(x.shape)
    dim = dim % x.ndim
    # every NaN made +NaN: torch.sort on a CUDA tensor puts a NaN with its
    # sign bit set below -inf where it sorts by radix (long rows)
    x = torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)
    xs = torch.where(mask, x, torch.full((), float("inf"), dtype=x.dtype, device=x.device))
    xs, _ = torch.sort(xs, dim=dim)
    n = mask.sum(dim=dim, keepdim=True)
    lo_idx = torch.clamp((n - 1) // 2, min=0)
    hi_idx = torch.clamp(n // 2, min=0)
    lo = torch.gather(xs, dim, lo_idx)
    hi = torch.gather(xs, dim, hi_idx)
    med = 0.5 * (lo + hi)
    med = torch.where(n > 0, med, torch.full((), float("nan"), dtype=x.dtype, device=x.device))
    return med.squeeze(dim)


def median(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """Exact median along ``dim`` (None = over all elements)."""
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return masked_median(x, torch.ones((), dtype=torch.bool, device=x.device), dim)
