"""Pulse descriptor words from detection streams (time last), MATLAB
semantics kept exactly (``create_pdws.m:51-105``,
``create_pdws_channelized.m:79-136``): the leading edge at mag >= floor *
10^(lead/10), the trailing edge at mag <= floor * 10^(trail/10) (the same
threshold without hysteresis); TOA the 1-based sample; the trailing-edge
sample inside the median windows; phase differences wrapped once into
[-180, 180] with strict inequalities; saturation strictly inside the
pulse; a pulse still open at the end of the capture dropped.  A frozen
copy of the port's oracle extractor (sort-based medians, a latch over
transfer functions), in blocks of channels so that it fits."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

# channels a call of the statistics: the windows are (rows, slots, window)
_ROWS = 8


@dataclasses.dataclass
class Batch:
    toa_idx: torch.Tensor
    te_idx: torch.Tensor
    mag: torch.Tensor
    snr_db: torch.Tensor
    freq_offset: torch.Tensor
    saturated: torch.Tensor
    valid: torch.Tensor
    wrap_margin: torch.Tensor   # degrees from the nearest difference to +-180


def masked_median(x: torch.Tensor, mask: torch.Tensor,
                  dim: int = -1) -> torch.Tensor:
    """MATLAB median where ``mask`` holds: the middle element, the mean of
    the two middle ones for an even count, NaN for none; NaNs sort high."""
    mask = mask.expand(x.shape)
    dim = dim % x.ndim
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    x = torch.where(torch.isnan(x), nan, x)
    xs = torch.where(mask, x, torch.full((), float("inf"), dtype=x.dtype,
                                         device=x.device))
    xs = torch.sort(xs, dim=dim).values
    n = mask.sum(dim=dim, keepdim=True)
    lo = torch.gather(xs, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(xs, dim, torch.clamp(n // 2, min=0))
    return torch.where(n > 0, 0.5 * (lo + hi), nan).squeeze(dim)


def median(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    if dim is None:
        x, dim = x.reshape(-1), 0
    return masked_median(x, torch.ones((), dtype=torch.bool,
                                       device=x.device), dim)


def thresholds(nf: torch.Tensor, cfg: dict):
    lead = nf * 10.0 ** (cfg["snr_threshold_db"] / 10.0)
    trail_db = cfg["trailing_threshold_db"]
    if trail_db is None:
        return lead, lead
    return lead, nf * 10.0 ** (trail_db / 10.0)


def transfer_fns(ge_lead: torch.Tensor, le_trail: torch.Tensor):
    """The latch's state after each sample had it started inactive (``a``)
    or active (``b``): each sample sets, resets, holds or toggles it."""
    t_len = ge_lead.shape[-1]
    const = ge_lead ^ le_trail
    toggle = ge_lead & le_trail
    pos = torch.arange(t_len, device=ge_lead.device)
    last = torch.cummax(torch.where(const, pos, torch.full_like(pos, -1)),
                        dim=-1).values
    safe = last.clamp(min=0)
    seen = last >= 0
    picked = torch.gather(ge_lead, -1, safe)
    tc = torch.cumsum(toggle.to(torch.int32), dim=-1)
    since = tc - torch.where(seen, torch.gather(tc, -1, safe),
                             torch.zeros_like(tc))
    odd = since % 2 == 1
    return (seen & picked) ^ odd, (~seen | picked) ^ odd


def edge_indices(edge: torch.Tensor, slots: int) -> torch.Tensor:
    """Positions of the first ``slots`` True entries, padded with the
    length."""
    t_len = edge.shape[-1]
    csum = torch.cumsum(edge.to(torch.int32), dim=-1)
    ranks = torch.arange(1, slots + 1, dtype=torch.int32,
                         device=edge.device).expand(*edge.shape[:-1], slots)
    return torch.searchsorted(csum, ranks.contiguous()).clamp(
        max=t_len).to(torch.int32)


def _emit(mag, ph, sat, nf, toa, te, valid, w) -> Batch:
    t_len = mag.shape[-1]
    lead = mag.shape[:-1]

    def padded(x, n, fill):
        return torch.cat([x, x.new_full((*lead, n), fill)], dim=-1)

    mag_p = padded(mag, w, float("inf"))
    dph = ph[..., 1:] - ph[..., :-1]
    dph = torch.where(dph < -180.0, dph + 360.0, dph)
    dph = torch.where(dph > 180.0, dph - 360.0, dph)
    dph_p = padded(dph, w + 1, 0.0)
    sat_p = padded(sat, w, False)
    pos = torch.arange(w, device=mag.device)
    i0 = toa.clamp(0, t_len).to(torch.int64)
    i1 = te.clamp(0, t_len).to(torch.int64)
    plen = torch.clamp(i1 - i0 + 1, max=w)[..., None]
    idx = (i0[..., None] + pos).reshape(*lead, -1)

    def windows(x):
        return torch.gather(x, -1, idx).reshape(*i0.shape, w)

    med_mag = masked_median(windows(mag_p), pos < plen)
    dph_w = windows(dph_p)
    in_dph = pos < plen - 1
    med_dph = masked_median(dph_w, in_dph)
    margin = torch.where(in_dph, 180.0 - dph_w.abs(),
                         torch.full((), 360.0, device=mag.device)).amin(-1)
    sat_in = (windows(sat_p) & (pos >= 1) & (pos < plen - 1)).any(-1)
    nf_b = nf if nf.ndim == 0 else nf[..., None]
    snr = 10.0 * torch.log10(med_mag / nf_b)
    return Batch(toa, te, med_mag, snr, med_dph / 360.0, valid & sat_in,
                 valid, margin)


def _rows(fn, mag, *rest):
    """``fn`` over blocks of ``_ROWS`` channels, the batches stacked."""
    if mag.ndim == 1:
        return fn(mag, *rest)
    parts = [fn(*(v[r:r + _ROWS] for v in (mag, *rest)))
             for r in range(0, mag.shape[0], _ROWS)]
    return Batch(**{f.name: torch.cat([getattr(b, f.name) for b in parts])
                    for f in dataclasses.fields(Batch)})


def extract_core(mag, ph, sat, nf, cfg: dict) -> Batch:
    """One shot over the whole capture: at most ``max_pulses`` a channel,
    the first in time."""
    slots, w = int(cfg["max_pulses"]), int(cfg["max_pulse_samples"])

    def one(mag, ph, sat, nf):
        lead, trail = thresholds(nf, cfg)
        state = transfer_fns(mag >= lead[..., None],
                             mag <= trail[..., None])[0]
        prev = torch.cat([torch.zeros_like(state[..., :1]), state[..., :-1]],
                         -1)
        toa = edge_indices(state & ~prev, slots)
        te = edge_indices(~state & prev, slots)
        count = (~state & prev).sum(-1).clamp(max=slots)
        valid = torch.arange(slots, device=mag.device) < count[..., None]
        return _emit(mag, ph, sat, nf, toa, te, valid, w)

    return _rows(one, mag, ph, sat, nf)


def block_core(mag, ph, sat, nf, entry, own_len: int, cfg: dict) -> Batch:
    """One block of a stream: ``own_len`` owned samples, then the
    look-ahead; the block emits the pulses whose leading edge it owns, at
    most ``max_pulses`` a channel, whose trailing edge falls inside it."""
    slots, w = int(cfg["max_pulses"]), int(cfg["max_pulse_samples"])

    def one(mag, ph, sat, nf, entry):
        lead, trail = thresholds(nf, cfg)
        a, b = transfer_fns(mag >= lead[..., None], mag <= trail[..., None])
        ent = entry[..., None]
        state = torch.where(ent, b, a)
        prev = torch.cat([ent.expand_as(state[..., :1]), state[..., :-1]],
                         -1)
        t_total = mag.shape[-1]
        owned = (state & ~prev) & (torch.arange(t_total, device=mag.device)
                                   < own_len)
        toa = edge_indices(owned, slots)
        trail_all = edge_indices(~state & prev, slots + 1)
        slot = torch.arange(slots, device=mag.device)
        te = torch.gather(trail_all, -1, (slot + ent.to(torch.int64)).expand(
            *trail_all.shape[:-1], slots))
        valid = (slot < owned.sum(-1)[..., None]) & (te < t_total)
        return _emit(mag, ph, sat, nf, toa, te, valid, w)

    return _rows(one, mag, ph, sat, nf, entry)


def block_transfer(mag, nf, cfg: dict):
    """The latch's transfer over a whole block: ``(f(0), f(1))``."""
    lead, trail = thresholds(nf, cfg)
    ge, le = mag >= lead[..., None], mag <= trail[..., None]
    pos = torch.arange(mag.shape[-1], dtype=torch.int32, device=mag.device)
    last = torch.where(ge ^ le, pos, torch.full_like(pos, -1)).amax(-1)
    seen = last >= 0
    picked = torch.gather(ge, -1, last.clamp(min=0).to(torch.int64)[..., None]
                          )[..., 0]
    odd = (ge & le & (pos > last[..., None])).sum(-1) % 2 == 1
    return (seen & picked) ^ odd, (~seen | picked) ^ odd


def extract_blocks(mag, ph, sat, nf, cfg: dict, block_frames: int):
    """The streamed contract over (M, T) streams: blocks of
    ``block_frames``, each with a look-ahead of ``max_pulse_samples``
    frames (one +inf frame after the last block), the latch carried from
    block to block.  Returns the blocks' batches and their first frames."""
    halo = int(cfg["max_pulse_samples"])
    t_total = mag.shape[-1]
    entry = torch.zeros(mag.shape[0], dtype=torch.bool, device=mag.device)
    batches, offsets = [], []
    for f0 in range(0, t_total, block_frames):
        t_k = min(block_frames, t_total - f0)
        h_k = min(halo, t_total - f0 - t_k)
        sl = slice(f0, f0 + t_k + h_k)
        m_b, p_b, s_b = mag[:, sl], ph[:, sl], sat[:, sl]
        if h_k < 1:
            m_b = torch.cat([m_b, m_b.new_full((m_b.shape[0], 1),
                                               float("inf"))], 1)
            p_b = torch.cat([p_b, p_b.new_zeros((p_b.shape[0], 1))], 1)
            s_b = torch.cat([s_b, s_b.new_zeros((s_b.shape[0], 1))], 1)
        batches.append(block_core(m_b, p_b, s_b, nf, entry, t_k, cfg))
        a, b = block_transfer(mag[:, f0:f0 + t_k], nf, cfg)
        entry = torch.where(entry, b, a)
        offsets.append(f0)
    return batches, offsets


def merge(batches: List[Batch], offsets: List[int]) -> Batch:
    """Blocks' batches side by side, their indices made absolute."""
    out = {}
    for f in dataclasses.fields(Batch):
        parts = []
        for b, off in zip(batches, offsets):
            v = getattr(b, f.name)
            if f.name in ("toa_idx", "te_idx"):
                v = v.to(torch.int64) + off
            parts.append(v)
        out[f.name] = torch.cat(parts, dim=-1)
    return Batch(**out)


def finalize(batch: Batch, fs: float, fc: float, start_time: float,
             bin_offsets_hz: Optional[np.ndarray] = None) -> dict:
    """Host float64 PDWs sorted by TOA: ``toa = (i0 + 1) / fs + t0``, ``pw =
    (jj - i0) / fs``, ``freq = fc + bin + fs * offset``."""
    def host(x, dtype):
        return np.asarray(x.detach().cpu().numpy(), dtype)

    toa_idx = host(batch.toa_idx, np.int64)
    te_idx = host(batch.te_idx, np.int64)
    valid = host(batch.valid, bool)
    if toa_idx.ndim == 1:
        channel = np.zeros_like(toa_idx)
        bins = np.zeros(1)
    else:
        channel = np.broadcast_to(np.arange(toa_idx.shape[0])[:, None],
                                  toa_idx.shape)
        bins = np.asarray(bin_offsets_hz, np.float64)
    sel = valid.ravel()
    ch = channel.ravel()[sel]
    i0 = toa_idx.ravel()[sel]
    i1 = te_idx.ravel()[sel]
    toa = (i0 + 1) / fs + start_time
    order = np.argsort(toa, kind="stable")
    return {
        "toa": toa[order],
        "freq": (fc + bins[ch] + host(batch.freq_offset, np.float64).ravel()
                 [sel] * fs)[order],
        "pw": ((i1 - i0) / fs)[order],
        "mag": host(batch.mag, np.float64).ravel()[sel][order],
        "snr": host(batch.snr_db, np.float64).ravel()[sel][order],
        "sat": host(batch.saturated, bool).ravel()[sel][order],
        "channel": ch[order],
        "wrap_margin_deg": host(batch.wrap_margin, np.float64).ravel()[sel][
            order],
    }
