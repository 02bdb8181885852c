"""Rank search over monotone cumulative counts.

The JAX package splits the search into two dense levels because gathers are
slow on its hardware; the function it computes is
``searchsorted(cum, rank, side="left")`` clamped to ``t_len``, which is one
``torch.searchsorted`` call over the channel-major rows.
"""

from __future__ import annotations

import torch


def find_ranks_cm(cum_cm: torch.Tensor, ranks: torch.Tensor, t_len: int) -> torch.Tensor:
    """First index with ``cum >= rank`` per (row, rank); ``t_len`` when the
    rank is never reached.

    ``cum_cm``: (rows, T) f32, monotone along T (may extend past ``t_len``).
    ``ranks``: (rows, R) f32.  Returns (rows, R) int32.
    """
    pos = torch.searchsorted(cum_cm.contiguous(), ranks.contiguous(), right=False)
    return torch.clamp(pos, max=t_len).to(torch.int32)


def take_at_cm(vals_cm: torch.Tensor, chan: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals_cm[chan, idx]`` per query: (M, T) values, (P,) channel and
    in-range sample indices -> (P,).  The JAX package reads one contiguous
    block per query and picks a lane, again because of its gathers; the
    function is one indexed read."""
    return vals_cm[chan.to(torch.int64), idx.to(torch.int64)]
