"""Pulse-descriptor-word (PDW) extraction.

Semantics of the reference's sequential edge detectors (wideband
``matlab/create_pdws.m:51-105``, channelized
``create_pdws_channelized.m:79-136``), kept exactly:

* TOA uses the MATLAB 1-based sample index: ``toa = (i0 + 1)/fs + t0``;
* the trailing-edge sample IS included in the median magnitude and phase
  difference windows (``median(mag(toa:jj))``);
* pulse width is ``(jj - toa)/fs``;
* phase differences in degrees, wrapped once into [-180, 180] with strict
  inequalities (exactly +/-180 is not wrapped);
* saturation (|I| or |Q| >= level) is checked strictly inside the pulse,
  not at the leading- or trailing-edge samples;
* frequency is ``fc + fs * medPhaseDiff / 360``;
* a pulse still active at the end of the capture is not emitted.

Two kinds of extractor live here.  ``extract_pdws_core`` and its block
form ``extract_pdws_block_core`` are the oracle: a two-bit latch over {set,
reset, hold, toggle}, edge lists, gathered windows and sort-based medians,
all plain PyTorch.  ``_extract_channelized_cm2`` (the single-shot main
path's tail) and ``_extract_channelized_pallas_stats`` (the tail of the
streamed block, of the flat and cm routes and of wideband extraction, which
is its one-channel case) consume detection streams and run the latch, the
flip, the rank search and the per-pulse statistics through the hand-written
kernels (``ops.cuda``).  ``_extract_event_core`` is the real-time
tracker's event-mode extractor (one threshold, no memory, mean amplitudes
from prefix sums, no window), plain PyTorch on any device.

``stats`` chooses the tail where an entry point offers it (the values keep
the names of the JAX package): ``"pallas"`` is the kernel tail, ``"xla"``
the oracle tail, ``"blocked"`` (wideband only) the kernel tail block by
block.  ``"auto"`` is the kernel tail for tensors on a CUDA device, whatever
the capture's length or the window, and the oracle tail for tensors on the
CPU; an explicit ``"pallas"`` on the CPU runs the kernel tail through the
kernels' plain versions.  From 2^24 samples on the wideband kernel tail
goes block by block, because the latch counts are float32.

The block contract, shared by the three block-capable extractors: the
streams cover ``own_len`` owned samples plus a right halo, the latch enters
in ``entry_active``, and a block emits exactly the pulses whose leading edge
it owns; trailing edges and statistics may reach into the halo.  A block's
exit state follows from ``block_transfer``, and transfers compose
(``compose_transfer``), so blocks chain without looking back.

Device code returns integer indices and float32 metrics; absolute times
and frequencies are finalized on the host in float64
(:func:`finalize_pdws`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.cuda import transpose_kernel
from sdr_channelizer_tpu_torch.ops.medians import masked_median, median
from sdr_channelizer_tpu_torch.ops.rank_find import find_ranks_cm

# Closed pulses up to this many samples go through the statistics kernel
# with this window; longer ones with ``max_pulse_samples``.
_SHORT_WINDOW = 128
# Tiles of 128 slots a batch of the statistics kernel, passed as
# ``batch_tiles`` by every statistics call of the kernel tails: 0 or 1 runs
# the per-slot kernel K4, above 1 the batched kernel B10 over the live tiles
# (the JAX package's knob of the same name; the same values either way).
_STATS_BATCH = 1

# the detection streams of a capture, shared with the fused wideband kernel's
# plain version (``ops.cuda.transpose_kernel``)
_RAD2DEG = transpose_kernel.RAD2DEG
_prep_streams = transpose_kernel.prep_streams
# from this many samples on the wideband kernel tail goes block by block,
# in blocks of this many samples
_WIDEBAND_BLOCKED_FROM = 1 << 24
_WIDEBAND_BLOCK_LEN = 1 << 23


@dataclasses.dataclass
class PdwBatch:
    """Fixed-capacity batch of PDWs.

    Tensors have a trailing dimension ``max_pulses`` (after a channel
    dimension for channelized batches).  Only the first ``count`` entries
    per channel (the ``valid`` mask) are real.
    """

    toa_idx: torch.Tensor  # i32, 0-based leading-edge sample index
    te_idx: torch.Tensor  # i32, 0-based trailing-edge sample index
    pw_sec: torch.Tensor  # f32, te - toa in samples (scaled on the host)
    mag: torch.Tensor  # f32, median |iq| over the pulse
    snr_db: torch.Tensor  # f32, 10*log10(mag/noise_floor)
    freq_offset_hz: torch.Tensor  # f32, medPhaseDiff/360 cycles per sample
    saturated: torch.Tensor  # bool
    valid: torch.Tensor  # bool
    count: torch.Tensor  # i32, number of valid PDWs


def _thresholds(noise_floor: torch.Tensor, snr_threshold_db: float,
                trailing_threshold_db: Optional[float]):
    lead = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    if trailing_threshold_db is None:
        return lead, lead
    return lead, noise_floor * 10.0 ** (trailing_threshold_db / 10.0)


def _core_kwargs(cfg: PdwConfig) -> dict:
    """The keyword arguments of :func:`extract_pdws_block_core` (and, with
    ``saturation_level``, of :func:`extract_pdws_core`) that ``cfg`` holds."""
    return dict(snr_threshold_db=cfg.snr_threshold_db,
                trailing_threshold_db=cfg.trailing_threshold_db,
                max_pulses=cfg.max_pulses,
                max_pulse_samples=cfg.max_pulse_samples)


def compose_transfer(f1, f2):
    """Compose boolean-latch transfer functions: apply ``f1``, then ``f2``.

    A transfer function is the pair ``(f(0), f(1))``; the composition is
    ``(f2(a1), f2(b1))`` and is associative.  It chains the latch across
    streamed blocks (identity ``(False, True)``)."""
    a1, b1 = f1
    a2, b2 = f2
    return torch.where(a1, b2, a2), torch.where(b1, b2, a2)


def hysteresis_fns(ge_lead: torch.Tensor, le_trail: torch.Tensor,
                   dim: int = -1):
    """Prefix transfer functions ``(a, b)`` of the pulse-active latch along
    ``dim``.

    Each sample is a transfer function of the boolean latch, the pair
    ``(f(0), f(1)) = (ge_lead, ~le_trail)``: set, reset, hold, or (when a
    sample meets both thresholds at once) toggle.  At each position ``a`` is
    the state had the latch started inactive, ``b`` had it started active:
    the state of the last set or reset at or before the sample, else the
    start state, flipped once per toggle since.  An entry state seeds it as
    ``torch.where(entry, b, a)``.
    """
    ge_lead = ge_lead.movedim(dim, -1)
    le_trail = le_trail.movedim(dim, -1)
    t_len = ge_lead.shape[-1]
    const = ge_lead ^ le_trail           # set (1, 1) or reset (0, 0)
    toggle = ge_lead & le_trail          # (1, 0)
    pos = torch.arange(t_len, device=ge_lead.device)
    last = torch.cummax(
        torch.where(const, pos, torch.full_like(pos, -1)), dim=-1).values
    safe = last.clamp(min=0)
    seen = last >= 0
    picked = torch.gather(ge_lead, -1, safe)
    tc = torch.cumsum(toggle.to(torch.int32), dim=-1)
    since = tc - torch.where(seen, torch.gather(tc, -1, safe),
                             torch.zeros_like(tc))
    odd = since % 2 == 1
    a = (seen & picked) ^ odd
    b = (~seen | picked) ^ odd
    return a.movedim(-1, dim), b.movedim(-1, dim)


def hysteresis_scan(ge_lead: torch.Tensor, le_trail: torch.Tensor,
                    dim: int = -1) -> torch.Tensor:
    """Pulse-active state after each sample along ``dim``, the latch
    starting inactive (the reference's ``pulseActive = false``)."""
    return hysteresis_fns(ge_lead, le_trail, dim=dim)[0]


def _edge_indices(edge: torch.Tensor, max_pulses: int) -> torch.Tensor:
    """Indices of the True entries along the last dimension, padded with its
    length (an out-of-range sentinel) to ``max_pulses``: the r-th edge is
    the first position whose running count reaches r + 1."""
    t_len = edge.shape[-1]
    csum = torch.cumsum(edge.to(torch.int32), dim=-1)
    ranks = torch.arange(1, max_pulses + 1, dtype=torch.int32,
                         device=edge.device).expand(*edge.shape[:-1], max_pulses)
    return torch.searchsorted(csum, ranks.contiguous(), right=False).clamp(
        max=t_len).to(torch.int32)


def extract_pdws_core(
    mag: torch.Tensor,
    phase_deg: torch.Tensor,
    sat_sample: torch.Tensor,
    noise_floor: torch.Tensor,
    *,
    snr_threshold_db: float,
    trailing_threshold_db: Optional[float],
    saturation_level: float,
    max_pulses: int,
    max_pulse_samples: int,
) -> PdwBatch:
    """The oracle extractor over detection streams with time last.

    ``mag``, ``phase_deg``, ``sat_sample``: (T,) or (M, T);
    ``noise_floor``: scalar or (M,).  The keywords are the ``PdwConfig``
    fields of the same names; ``saturation_level`` is unused, as in the
    JAX package (``sat_sample`` holds the comparison already).
    """
    del saturation_level
    lead, trail = _thresholds(noise_floor, snr_threshold_db,
                              trailing_threshold_db)
    state = hysteresis_scan(mag >= lead[..., None], mag <= trail[..., None])
    prev = torch.cat([torch.zeros_like(state[..., :1]), state[..., :-1]], -1)
    lead_edge = state & ~prev
    trail_edge = ~state & prev  # True exactly at the reference's `jj`
    toa_idx = _edge_indices(lead_edge, max_pulses)
    te_idx = _edge_indices(trail_edge, max_pulses)
    # A capture with more pulses than slots drops the overflow.
    count = trail_edge.sum(-1).clamp(max=max_pulses).to(torch.int32)
    valid = torch.arange(max_pulses, device=mag.device) < count[..., None]
    return _emit_batch(mag, phase_deg, sat_sample, noise_floor, toa_idx,
                       te_idx, valid, count, max_pulse_samples)


def extract_pdws_block_core(
    mag: torch.Tensor,
    phase_deg: torch.Tensor,
    sat_sample: torch.Tensor,
    noise_floor: torch.Tensor,
    entry_active: torch.Tensor,
    *,
    own_len: int,
    snr_threshold_db: float,
    trailing_threshold_db: Optional[float],
    max_pulses: int,
    max_pulse_samples: int,
) -> PdwBatch:
    """The oracle extractor for one time block (the block contract above).

    ``mag``, ``phase_deg``, ``sat_sample``: (T,) or (M, T), ``own_len`` owned
    samples and then the right halo: the head of the next block, or +inf
    magnitude past the end of the capture, which keeps the latch set so the
    last pulse stays unmatched.  ``noise_floor`` and the boolean
    ``entry_active``: scalar or (M,).  With a halo at least one sample longer
    than the longest pulse, the blocks' PDWs, offset by the block starts,
    are those of :func:`extract_pdws_core` over the whole capture.  The
    keywords besides ``own_len`` are the ``PdwConfig`` fields of the same
    names.
    """
    lead, trail = _thresholds(noise_floor, snr_threshold_db,
                              trailing_threshold_db)
    a, b = hysteresis_fns(mag >= lead[..., None], mag <= trail[..., None])
    entry = entry_active[..., None]
    state = torch.where(entry, b, a)
    prev = torch.cat([entry.expand_as(state[..., :1]), state[..., :-1]], -1)
    lead_edge = state & ~prev
    trail_edge = ~state & prev

    t_total = mag.shape[-1]
    owned_lead = lead_edge & (torch.arange(t_total, device=mag.device)
                              < own_len)
    toa_idx = _edge_indices(owned_lead, max_pulses)
    # Latch events alternate; when the block enters active, its first event
    # is the trailing edge of the previous block's pulse: skip it.
    trail_all = _edge_indices(trail_edge, max_pulses + 1)
    slot = torch.arange(max_pulses, device=mag.device)
    te_idx = torch.gather(
        trail_all, -1,
        (slot + entry.to(torch.int64)).expand(*trail_all.shape[:-1],
                                              max_pulses))
    n_own = owned_lead.sum(-1)
    matched = (slot < n_own[..., None]) & (te_idx < t_total)
    count = matched.sum(-1).to(torch.int32)
    return _emit_batch(mag, phase_deg, sat_sample, noise_floor, toa_idx,
                       te_idx, matched, count, max_pulse_samples)


def block_transfer(mag: torch.Tensor, noise_floor: torch.Tensor,
                   snr_threshold_db: float,
                   trailing_threshold_db: Optional[float]):
    """Whole-block latch transfer function ``(f(0), f(1))`` over the last
    dimension of ``mag``; ``noise_floor`` broadcasts against it.  Composing
    these across blocks gives each block's ``entry_active``.

    The last column of :func:`hysteresis_fns`, by reductions instead of
    scans: the block ends in the state of its last set or reset (or its
    start state, if it has none), flipped once per toggle after it."""
    lead, trail = _thresholds(noise_floor, snr_threshold_db,
                              trailing_threshold_db)
    ge_lead, le_trail = mag >= lead, mag <= trail
    pos = torch.arange(mag.shape[-1], dtype=torch.int32, device=mag.device)
    last = torch.where(ge_lead ^ le_trail, pos,
                       torch.full_like(pos, -1)).amax(-1)
    seen = last >= 0
    picked = torch.gather(ge_lead, -1,
                          last.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    odd = (ge_lead & le_trail & (pos > last[..., None])).sum(-1) % 2 == 1
    return (seen & picked) ^ odd, (~seen | picked) ^ odd


def batch_to_host(batch: PdwBatch) -> PdwBatch:
    """The batch with every field a NumPy array on the host."""
    return PdwBatch(**{
        f.name: getattr(batch, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(PdwBatch)})


def _emit_batch(mag, phase_deg, sat_sample, noise_floor, toa_idx, te_idx,
                valid, count, w) -> PdwBatch:
    """Per-pulse statistics over gathered windows, and the batch."""
    t_len = mag.shape[-1]
    lead_shape = mag.shape[:-1]

    def padded(x, n, fill):
        return torch.cat([x, x.new_full((*lead_shape, n), fill)], dim=-1)

    mag_p = padded(mag, w, float("inf"))
    dph = phase_deg[..., 1:] - phase_deg[..., :-1]
    dph = torch.where(dph < -180.0, dph + 360.0, dph)
    dph = torch.where(dph > 180.0, dph - 360.0, dph)
    dph_p = padded(dph, w + 1, 0.0)
    sat_p = padded(sat_sample, w, False)

    pos = torch.arange(w, device=mag.device)
    i0 = toa_idx.clamp(0, t_len).to(torch.int64)
    i1 = te_idx.clamp(0, t_len).to(torch.int64)
    plen = torch.clamp(i1 - i0 + 1, max=w)[..., None]  # samples toa..jj
    idx = (i0[..., None] + pos).reshape(*lead_shape, -1)

    def windows(x):
        return torch.gather(x, -1, idx).reshape(*i0.shape, w)

    med_mag = masked_median(windows(mag_p), pos < plen)
    # diff(phase(toa:jj)) = dph[toa .. jj-1], plen-1 entries
    med_dph = masked_median(windows(dph_p), pos < plen - 1)
    # saturation strictly inside the pulse: samples toa+1 .. jj-1
    sat = (windows(sat_p) & (pos >= 1) & (pos < plen - 1)).any(-1)

    nf = noise_floor if noise_floor.ndim == 0 else noise_floor[..., None]
    snr = 10.0 * torch.log10(med_mag / nf)
    zero = mag.new_zeros(())
    return PdwBatch(
        toa_idx=torch.where(valid, toa_idx, -1),
        te_idx=torch.where(valid, te_idx, -1),
        pw_sec=torch.where(valid, (te_idx - toa_idx).to(torch.float32), zero),
        mag=torch.where(valid, med_mag, zero),
        snr_db=torch.where(valid, snr, zero),
        freq_offset_hz=torch.where(valid, med_dph / 360.0, zero),
        saturated=valid & sat,
        valid=valid,
        count=count,
    )


def _prep_streams_planes(yr: torch.Tensor, yi: torch.Tensor,
                         saturation_level: float):
    """Detection streams from real and imaginary float planes."""
    mag = torch.sqrt(yr * yr + yi * yi)
    phase_deg = torch.atan2(yi, yr) * _RAD2DEG
    sat = (yr.abs() >= saturation_level) | (yi.abs() >= saturation_level)
    return mag, phase_deg, sat


def _kernel_tail(stats: str, where: torch.Tensor) -> bool:
    """Whether ``stats`` means the kernel tail for tensors on ``where``'s
    device (see the module docstring)."""
    if stats not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown stats {stats!r}")
    return stats == "pallas" or (stats == "auto" and where.is_cuda)


def _wideband_tail(stats: str, where: torch.Tensor, t_len: int) -> str:
    """The wideband tail ``stats`` means for ``t_len`` samples on
    ``where``'s device: ``"pallas"`` (the single-shot kernel tail),
    ``"blocked"`` or ``"xla"``."""
    if stats != "blocked" and _kernel_tail(stats, where):
        return "blocked" if t_len >= _WIDEBAND_BLOCKED_FROM else "pallas"
    return stats


def _extract_wideband_from_streams(
    mag: torch.Tensor,
    phase_deg: torch.Tensor,
    sat: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: torch.Tensor,
    stats: str = "auto",
    cm_streams=None,
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Wideband extraction from (T,) detection streams: the kernel tail as
    its one-channel case, block by block from 2^24 samples on, or the
    oracle tail.  ``cm_streams`` as in :func:`_wideband_tail_run`."""
    return _wideband_tail_run(
        mag, phase_deg, sat, cfg, noise_floor,
        _wideband_tail(stats, mag, mag.shape[-1]), cm_streams, ops)[1]


def _wideband_tail_run(mag, phase_deg, sat, cfg: PdwConfig, noise_floor,
                       tail: str, cm_streams, ops):
    """The wideband tail ``tail`` (as :func:`_wideband_tail` resolves it) on
    (T,) detection streams, shared by the complex and the planes entry
    points.  ``cm_streams`` are the one-channel ``(mag_cm, dph_cm,
    sat_cm)`` made beside ``mag`` (the single-shot kernel tail only; the
    phase and mask are then not needed).  Returns ``(noise_floor,
    PdwBatch)``; a floor not given is K2's on ``mag``."""
    if noise_floor is None:
        noise_floor = noise_floor_1d(mag, ops=ops)
    if tail == "blocked":
        return noise_floor, _extract_wideband_blocked(
            mag, phase_deg, sat, cfg, noise_floor, ops=ops)
    if tail == "pallas":
        batch = _extract_channelized_pallas_stats(
            mag[:, None], None if phase_deg is None else phase_deg[:, None],
            None if sat is None else sat[:, None], cfg,
            noise_floor.reshape(1), cm_streams=cm_streams, ops=ops)
        return noise_floor, PdwBatch(**{f.name: getattr(batch, f.name)[0]
                                        for f in dataclasses.fields(PdwBatch)})
    return noise_floor, extract_pdws_core(
        mag, phase_deg, sat, noise_floor,
        saturation_level=cfg.saturation_level, **_core_kwargs(cfg))


def extract_pdws_with_floor(
    iq: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    stats: str = "auto",
    ops=kernels.KERNELS,
):
    """:func:`extract_pdws`, returning ``(noise_floor, PdwBatch)``."""
    tail = _wideband_tail(stats, iq, iq.shape[-1])
    if tail == "pallas":   # the one-channel streams from the capture at once
        mag, dph_cm, sat_cm = ops.wideband_streams(iq.contiguous(),
                                                   cfg.saturation_level)
        return _wideband_tail_run(mag, None, None, cfg, noise_floor, tail,
                                  (mag[None], dph_cm, sat_cm), ops)
    mag, phase_deg, sat = _prep_streams(iq, cfg.saturation_level)
    return _wideband_tail_run(mag, phase_deg, sat, cfg, noise_floor, tail,
                              None, ops)


def extract_pdws(
    iq: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    stats: str = "auto",
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Wideband PDW extraction from a 1-D complex capture.

    ``pw_sec`` / ``freq_offset_hz`` in the returned batch are in units of
    samples and cycles per sample; :func:`finalize_pdws` scales them by the
    true ``fs`` on the host.  ``stats`` as in the module docstring; the
    single-shot kernel tail makes its streams from the capture in one
    kernel (``ops.wideband_streams``).
    """
    return extract_pdws_with_floor(iq, cfg, noise_floor, stats, ops)[1]


def extract_pdws_planes(
    yr: torch.Tensor,
    yi: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    stats: str = "auto",
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Wideband extraction from two float planes: the routing of
    :func:`extract_pdws`."""
    mag, phase_deg, sat = _prep_streams_planes(yr, yi, cfg.saturation_level)
    return _wideband_tail_run(mag, phase_deg, sat, cfg, noise_floor,
                              _wideband_tail(stats, yr, yr.shape[-1]), None,
                              ops)[1]


def extract_pdws_channelized_streams(
    mag: torch.Tensor,
    phase_deg: torch.Tensor,
    sat: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    stats: str = "auto",
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Per-channel extraction from time-major (T, M) detection streams
    (``sat`` a bool or 0/1 mask); ``stats`` as in the module docstring.
    On the kernel tail the streams are flipped once, and a floor that is
    not given is taken on the flipped magnitude."""
    if _kernel_tail(stats, mag):
        cm = ops.cm_streams(mag.contiguous(), phase_deg.contiguous(),
                            sat.contiguous())
        if noise_floor is None:
            noise_floor = noise_floor_cm(cm[0], mag.shape[1], mag.shape[0],
                                         ops=ops)
        return _extract_channelized_pallas_stats(
            mag, None, None, cfg, noise_floor, cm_streams=cm, ops=ops)
    if noise_floor is None:
        noise_floor = median(mag, dim=0)
    return extract_pdws_core(mag.T.contiguous(), phase_deg.T.contiguous(),
                             sat.T.contiguous().to(torch.bool), noise_floor,
                             saturation_level=cfg.saturation_level,
                             **_core_kwargs(cfg))


def extract_pdws_channelized_planes(
    yr: torch.Tensor,
    yi: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Per-channel extraction from (T, M) float planes."""
    mag, phase_deg, sat = _prep_streams_planes(yr, yi, cfg.saturation_level)
    return extract_pdws_channelized_streams(mag, phase_deg, sat, cfg,
                                            noise_floor, ops=ops)


def extract_pdws_channelized(
    chan_iq: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
) -> PdwBatch:
    """Per-channel oracle extraction from a channelized (T, M) complex
    matrix: the noise floor is per channel (median over time), detection is
    independent per channel.  Batch tensors have shape (M, max_pulses)."""
    mag, phase_deg, sat = _prep_streams(chan_iq, cfg.saturation_level)
    return extract_pdws_channelized_streams(mag, phase_deg, sat, cfg,
                                            noise_floor, stats="xla")


def noise_floor_cm(mag_cm: torch.Tensor, m: int, t_len: int,
                   ops=kernels.KERNELS) -> torch.Tensor:
    """Per-channel median noise floor of the first ``m`` rows and ``t_len``
    columns of the channel-major magnitude (exact median over the whole
    capture, ``create_pdws_channelized.m:73``)."""
    return ops.noise_floor(mag_cm[:m], t_len)


def noise_floor_1d(mag: torch.Tensor, ops=kernels.KERNELS) -> torch.Tensor:
    """The wideband floor, the median of the whole 1-D magnitude
    (``create_pdws.m``), as a 0-d tensor: the noise floor kernel's one
    row."""
    return ops.noise_floor(mag.reshape(1, -1), mag.numel()).reshape(())


def _extract_channelized_cm2(
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    satcs_cm: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: torch.Tensor,
    t_len: int,
    m: int,
    ops=kernels.KERNELS,
    entry_active: Optional[torch.Tensor] = None,
    own_len: Optional[int] = None,
    mag_latch_cm: Optional[torch.Tensor] = None,
) -> PdwBatch:
    """Channel-major extraction: the main path's tail.

    Inputs are the channelizer kernel's streams: (R >= m, T >= t_len)
    channel-major magnitude and wrapped phase difference plus the
    saturation cumulative count.

    * The latch runs channel-major and leaves the leading and trailing edge
      counts stacked in one (2R, T) tensor, so one rank search finds every
      edge of every channel.
    * The statistics run in three tiers on the per-channel (m, max_pulses)
      slot grid.  Tiny pulses (at most 2 samples) have closed forms: the
      median magnitude is the mean of the one or two samples, the median
      phase difference the single first difference (or NaN).  Short closed
      pulses (at most 128 samples) and the rest go through the statistics
      kernel with the window 128 and ``max_pulse_samples``; a slot outside
      a tier is handed over as dead.
    * Saturation comes from the cumulative count: the interior samples
      ``toa + 1 .. te - 1`` hold ``S[te - 1] - S[toa]`` saturated ones.

    ``entry_active`` (per channel) and ``own_len`` give this path the block
    contract of :func:`extract_pdws_block_core`; the defaults are the whole
    capture: the latch starts inactive and everything is owned.
    ``mag_latch_cm`` is an optional magnitude for the latch alone (a caller
    writes +inf over halo columns past the end of the capture there, so an
    open pulse never closes); the statistics keep reading ``mag_cm``.
    """
    if t_len < 1:
        raise ValueError("capture shorter than one channelizer frame")
    p_slots = cfg.max_pulses
    w = cfg.max_pulse_samples
    r = mag_cm.shape[0]
    dev = mag_cm.device
    own = t_len if own_len is None else own_len

    lead_thresh, trail_thresh = _thresholds(
        noise_floor, cfg.snr_threshold_db, cfg.trailing_threshold_db)
    latch_in = mag_cm if mag_latch_cm is None else mag_latch_cm
    entry_f = None if entry_active is None else \
        entry_active.to(device=dev, dtype=torch.float32)
    packed = ops.latch(latch_in[:, :t_len].contiguous(), lead_thresh,
                       trail_thresh, m, entry_f)
    # (2R, t_len): rows [0, R) lead counts, [R, 2R) trail: one search.
    # When the block enters active, its first trailing edge closes the
    # previous block's pulse: skip it (latch events alternate).
    ranks = torch.arange(1, p_slots + 1, dtype=torch.float32,
                         device=dev).expand(2 * r, p_slots)
    if entry_f is not None:
        skip = torch.zeros(2 * r, dtype=torch.float32, device=dev)
        skip[r:r + m] = entry_f
        ranks = ranks + skip[:, None]
    idx = find_ranks_cm(packed, ranks, t_len)
    toa_idx = idx[:m]
    te_idx = idx[r:r + m]
    # leading edges in the owned region; ranks past n_own point into the
    # halo and are masked out by `matched`
    n_own = packed[:m, own - 1].to(torch.int32)

    slot = torch.arange(p_slots, device=dev)
    matched = (slot < n_own[:, None]) & (te_idx < t_len)
    count = matched.sum(1).clamp(max=cfg.max_pulses).to(torch.int32)
    valid = slot < count[:, None]

    plen = te_idx - toa_idx + 1
    valid_slot = toa_idx < t_len
    closed = valid_slot & (te_idx < t_len)
    safe_toa = toa_idx.clamp(max=t_len - 1).to(torch.int64)
    safe_te = te_idx.clamp(max=t_len - 1).to(torch.int64)

    mag_a = torch.gather(mag_cm[:m], 1, safe_toa)
    mag_b = torch.gather(mag_cm[:m], 1, safe_te)
    tiny_mag = torch.where(plen >= 2, 0.5 * (mag_a + mag_b), mag_a)
    nan = torch.full((), float("nan"), device=dev)
    tiny_dph = torch.where(plen >= 2, torch.gather(dph_cm[:m], 1, safe_toa),
                           nan)

    # Exact for every tier: plen <= 2 has an empty interior, difference 0.
    s_hi = torch.gather(satcs_cm[:m], 1, (safe_te - 1).clamp(min=0))
    s_lo = torch.gather(satcs_cm[:m], 1, safe_toa)
    sat_any = (s_hi - s_lo) > 0.5

    sentinel = torch.full((), t_len, dtype=torch.int32, device=dev)

    def tier(sel, window):
        return ops.pulse_stats(
            mag_cm, dph_cm, torch.where(sel, toa_idx, sentinel),
            torch.where(sel, te_idx, sentinel), window, t_len,
            batch_tiles=_STATS_BATCH)

    if w > _SHORT_WINDOW:
        is_tiny = closed & (plen <= 2)
        is_short = closed & ~is_tiny & (plen <= _SHORT_WINDOW)
        is_long = valid_slot & ~is_tiny & ~is_short
        s_mag, s_dph = tier(is_short, _SHORT_WINDOW)
        l_mag, l_dph = tier(is_long, w)
        med_mag = torch.where(is_tiny, tiny_mag,
                              torch.where(is_short, s_mag, l_mag))
        med_dph = torch.where(is_tiny, tiny_dph,
                              torch.where(is_short, s_dph, l_dph))
    else:
        med_mag, med_dph = ops.pulse_stats(mag_cm, dph_cm, toa_idx, te_idx,
                                           w, t_len, batch_tiles=_STATS_BATCH)

    snr = 10.0 * torch.log10(med_mag / noise_floor[:, None])
    zero = mag_cm.new_zeros(())
    return PdwBatch(
        toa_idx=torch.where(valid, toa_idx, -1),
        te_idx=torch.where(valid, te_idx, -1),
        pw_sec=torch.where(valid, (te_idx - toa_idx).to(torch.float32), zero),
        mag=torch.where(valid, med_mag, zero),
        snr_db=torch.where(valid, snr, zero),
        freq_offset_hz=torch.where(valid, med_dph / 360.0, zero),
        saturated=valid & sat_any,
        valid=valid,
        count=count,
    )


def extract_pdws_channelized_streams_cm(
    mag: torch.Tensor,
    mag_cm: torch.Tensor,
    dph_cm: torch.Tensor,
    sat_cm: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Per-channel extraction from the streams of the channelizer kernel's
    cm form: ``mag`` the time-major (T, M) magnitude (latch and noise
    floor), ``mag_cm`` / ``dph_cm`` / ``sat_cm`` the channel-major (M, T)
    streams, ``sat_cm`` a 0/1 mask."""
    if noise_floor is None:
        noise_floor = noise_floor_cm(mag_cm, mag.shape[1], mag.shape[0],
                                     ops=ops)
    return _extract_channelized_pallas_stats(
        mag, None, None, cfg, noise_floor,
        cm_streams=(mag_cm, dph_cm, sat_cm), ops=ops)


def _extract_channelized_pallas_stats(
    mag: torch.Tensor,
    phase_deg: Optional[torch.Tensor],
    sat: Optional[torch.Tensor],
    cfg: PdwConfig,
    noise_floor: torch.Tensor,
    entry_active: Optional[torch.Tensor] = None,
    own_len: Optional[int] = None,
    cm_streams=None,
    ops=kernels.KERNELS,
) -> PdwBatch:
    """Channelized extraction from a time-major magnitude: the kernel tail
    of the streamed block, of the flat and cm routes and of wideband
    extraction (the function keeps the name of its JAX counterpart).

    ``mag`` is (T, M); ``cm_streams`` are the channel-major ``(mag_cm,
    dph_cm, sat_cm)`` that the channelizer kernel's cm form wrote beside it,
    ``sat_cm`` a 0/1 mask.  Without them the flip kernel makes them from
    ``mag``, the time-major phase ``phase_deg`` in degrees and the mask
    ``sat`` (bool or 0/1).  The latch runs on the time-major magnitude and
    leaves the edge counts stacked channel-major, one rank search finds the
    edges, and the statistics kernel reads the saturation mask itself.
    ``entry_active`` / ``own_len`` give the block contract of
    :func:`extract_pdws_block_core`; the defaults are the whole capture.

    Tiers: tiny pulses (at most 2 samples) have closed forms and an empty
    interior; short closed pulses (at most 128 samples) and the rest go
    through the statistics kernel as two flat slot lists, every slot with
    its channel, a slot outside the tier handed over as dead.  A dead slot
    costs the kernel one index read, so the lists are not compacted.  A
    configuration whose ``max_pulse_samples`` is no longer than the short
    window has one tier and takes the slot grid as it is.
    """
    t_len, m = mag.shape
    if t_len < 1:
        raise ValueError("block shorter than one channelizer frame")
    p_slots = cfg.max_pulses
    w = cfg.max_pulse_samples
    dev = mag.device
    own = t_len if own_len is None else own_len

    lead_thresh, trail_thresh = _thresholds(
        noise_floor, cfg.snr_threshold_db, cfg.trailing_threshold_db)
    entry_f = None if entry_active is None else \
        entry_active.to(device=dev, dtype=torch.float32)
    packed = ops.latch_tm(mag, lead_thresh, trail_thresh, entry_f)
    # (2M, t_len): rows [0, M) lead counts, [M, 2M) trail: one search.  When
    # the block enters active, its first trailing edge closes the previous
    # block's pulse: skip it (latch events alternate).
    ranks = torch.arange(1, p_slots + 1, dtype=torch.float32,
                         device=dev).expand(2 * m, p_slots)
    if entry_f is not None:
        ranks = ranks + torch.cat([torch.zeros_like(entry_f),
                                   entry_f])[:, None]
    idx = find_ranks_cm(packed, ranks, t_len)
    toa_idx, te_idx = idx[:m], idx[m:]
    # leading edges in the owned region; ranks past n_own point into the
    # halo and are masked out by `matched`
    n_own = packed[:m, own - 1].to(torch.int32)

    slot = torch.arange(p_slots, device=dev)
    matched = (slot < n_own[:, None]) & (te_idx < t_len)
    count = matched.sum(1).clamp(max=cfg.max_pulses).to(torch.int32)
    valid = slot < count[:, None]

    if cm_streams is not None:
        mag_cm, dph_cm, sat_cm = cm_streams
    else:
        # Only a block-contract caller can carry the +inf pad that keeps the
        # latch open past the end of the capture.  It is kept out of the
        # statistics streams, as in the JAX package; no matched pulse covers
        # it (the latch never closes over it), so emitted values are the
        # same.
        mag_s = torch.where(torch.isinf(mag), torch.zeros_like(mag), mag) \
            if own_len is not None else mag
        mag_cm, dph_cm, sat_cm = ops.cm_streams(mag_s.contiguous(),
                                                phase_deg.contiguous(),
                                                sat.contiguous())

    if w > _SHORT_WINDOW:
        plen = te_idx - toa_idx + 1
        valid_slot = toa_idx < t_len
        closed = valid_slot & (te_idx < t_len)
        is_tiny = closed & (plen <= 2)
        is_short = closed & ~is_tiny & (plen <= _SHORT_WINDOW)
        is_long = valid_slot & ~is_tiny & ~is_short

        safe_toa = toa_idx.clamp(max=t_len - 1).to(torch.int64)
        safe_te = te_idx.clamp(max=t_len - 1).to(torch.int64)
        mag_a = torch.gather(mag_cm[:m], 1, safe_toa)
        mag_b = torch.gather(mag_cm[:m], 1, safe_te)
        tiny_mag = torch.where(plen >= 2, 0.5 * (mag_a + mag_b), mag_a)
        nan = torch.full((), float("nan"), device=dev)
        tiny_dph = torch.where(
            plen >= 2, torch.gather(dph_cm[:m], 1, safe_toa), nan)

        sentinel = torch.full((), t_len, dtype=torch.int32, device=dev)
        chan = torch.arange(m, dtype=torch.int32,
                            device=dev).repeat_interleave(p_slots)

        def tier(sel, window):
            outs = ops.pulse_stats_dense(
                mag_cm, dph_cm, sat_cm,
                torch.where(sel, toa_idx, sentinel).reshape(-1),
                torch.where(sel, te_idx, sentinel).reshape(-1), chan, window,
                t_len, batch_tiles=_STATS_BATCH)
            return [o.reshape(m, p_slots) for o in outs]

        shorts, longs = tier(is_short, _SHORT_WINDOW), tier(is_long, w)
        tiny = (tiny_mag, tiny_dph, torch.zeros_like(tiny_mag))
        med_mag, med_dph, sat_any = (
            torch.where(is_tiny, t, torch.where(is_short, s_, l_))
            for t, s_, l_ in zip(tiny, shorts, longs))
    else:
        med_mag, med_dph, sat_any = ops.pulse_stats(
            mag_cm, dph_cm, toa_idx.contiguous(), te_idx.contiguous(), w,
            t_len, sat_cm, batch_tiles=_STATS_BATCH)

    snr = 10.0 * torch.log10(med_mag / noise_floor[:, None])
    zero = mag.new_zeros(())
    return PdwBatch(
        toa_idx=torch.where(valid, toa_idx, -1),
        te_idx=torch.where(valid, te_idx, -1),
        pw_sec=torch.where(valid, (te_idx - toa_idx).to(torch.float32), zero),
        mag=torch.where(valid, med_mag, zero),
        snr_db=torch.where(valid, snr, zero),
        freq_offset_hz=torch.where(valid, med_dph / 360.0, zero),
        saturated=valid & (sat_any > 0.5),
        valid=valid,
        count=count,
    )


def _wideband_block(
    mag_e: torch.Tensor,
    ph_e: torch.Tensor,
    sat_e: torch.Tensor,
    nf: torch.Tensor,
    entry: torch.Tensor,
    *,
    cfg: PdwConfig,
    own_len: int,
    end: bool,
    ops=kernels.KERNELS,
):
    """One block of :func:`_extract_wideband_blocked`: the (T,) streams of
    ``own_len`` owned samples and the halo, the (1,) floor and latch entry
    -> ``(batch, a, b)``, the one-channel batch and the block's latch
    transfer.  ``end``: the capture ends in this view, so a +inf magnitude
    is appended and open pulses die."""
    own = mag_e[:own_len]
    if end:
        mag_e = torch.cat([mag_e, mag_e.new_full((1,), float("inf"))])
        ph_e = torch.cat([ph_e, ph_e.new_zeros(1)])
        sat_e = torch.cat([sat_e, sat_e.new_zeros(1)])
    batch = _extract_channelized_pallas_stats(
        mag_e[:, None], ph_e[:, None], sat_e[:, None], cfg, nf,
        entry_active=entry, own_len=own_len, ops=ops)
    a, b = block_transfer(own[None, :], nf[:, None], cfg.snr_threshold_db,
                          cfg.trailing_threshold_db)
    return batch, a, b


def _extract_wideband_blocked(
    mag: torch.Tensor,
    phase_deg: torch.Tensor,
    sat: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: torch.Tensor,
    block_len: Optional[int] = None,
    ops=kernels.KERNELS,
    block_step=None,
) -> PdwBatch:
    """Wideband extraction through the kernel tail, block by block over the
    time axis (``_WIDEBAND_BLOCK_LEN`` samples a block unless ``block_len``
    is given): for captures of 2^24 samples and more, whose latch counts
    would not be exact in float32.  The latch is carried on the device by
    composing the blocks' transfer functions, every block sees a right halo
    of ``max_pulse_samples``: the block contract, in memory.

    Equal to the single-shot extractor for pulses no longer than the halo;
    a pulse open at the end of the capture is never emitted (a +inf
    magnitude is appended there, so it never closes).

    ``block_step`` runs a block as :func:`_wideband_block` does, without
    ``cfg`` and ``ops`` (a staged form of it); by default that function.
    The blocks' extractions and the transfer chain are all dispatched first;
    then every field comes to the host once, stacked over the blocks.
    """
    t_len = mag.shape[0]
    halo = cfg.max_pulse_samples
    block_len = block_len or _WIDEBAND_BLOCK_LEN
    step = functools.partial(_wideband_block, cfg=cfg, ops=ops) \
        if block_step is None else block_step
    nf = noise_floor.reshape(1)
    entry = torch.zeros(1, dtype=torch.bool, device=mag.device)
    n_blocks = (t_len + block_len - 1) // block_len

    names = [f.name for f in dataclasses.fields(PdwBatch) if f.name != "count"]
    batches, starts = [], []
    for k in range(n_blocks):
        s0 = k * block_len
        s1 = min(s0 + block_len, t_len)
        h1 = min(s1 + halo, t_len)
        batch, a, b = step(mag[s0:h1], phase_deg[s0:h1], sat[s0:h1], nf,
                           entry, own_len=s1 - s0, end=h1 == t_len)
        batches.append(batch)
        entry = torch.where(entry, b, a)
        starts.append(s0)

    # one stacked fetch per field (every block has the same slot axis)
    stacked = {n: torch.stack([getattr(b, n)[0] for b in batches]).cpu().numpy()
               for n in names}
    sel = stacked["valid"]
    cat = {}
    for n in names:
        v = stacked[n]
        if n in ("toa_idx", "te_idx"):
            v = v + np.asarray(starts, np.int32)[:, None]
        cat[n] = np.concatenate(
            [v[k][sel[k]] for k in range(n_blocks)])[: cfg.max_pulses]
    total = len(cat["toa_idx"])
    pad = cfg.max_pulses - total
    fills = {"toa_idx": -1, "te_idx": -1, "valid": False, "saturated": False}

    def padded(n):
        v = cat[n]
        return torch.as_tensor(np.concatenate(
            [v, np.full(pad, fills.get(n, 0), v.dtype)]), device=mag.device)

    return PdwBatch(
        count=torch.tensor(total, dtype=torch.int32, device=mag.device),
        **{n: padded(n) for n in names})


def _extract_event_core(
    mag: torch.Tensor,
    sat: torch.Tensor,
    noise_floor: torch.Tensor,
    snr_threshold_db: float,
    max_pulses: int,
    block: int = 512,
) -> PdwBatch:
    """Real-time event-mode wideband extraction: the C++ tracker's per-pulse
    statistics (``usrp_predict_event.cpp:300-343``), on (T,) streams.

    * The latch has one threshold and no memory: ``state[t] = mag[t] >
      thresh``.
    * Pulse amplitude is the **mean** magnitude over ``[toa, te)`` (the
      trailing-edge sample excluded), not the offline median, so there is no
      window: means come from two-level prefix sums (``block``-sample partial
      sums, a cumsum of the block sums, one gathered block per rank).
    * Saturation is any flagged sample strictly inside the pulse; no
      frequency is measured.  A pulse still open at capture end is not
      emitted.

    Plain PyTorch on any device: float32 sums within blocks, the prefix
    across blocks in float64 (the JAX package keeps it in float32; the C++
    loop accumulates ``double amp``); ``pw_sec`` in samples and a zero
    ``freq_offset_hz``, as the other cores.
    """
    dev = mag.device
    t_len = mag.shape[-1]
    pad = (-t_len) % block
    thresh = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    state = mag > thresh
    prev = torch.cat([state.new_zeros(1), state[:-1]])
    lead = (state & ~prev).to(torch.float32)
    trail = (~state & prev).to(torch.float32)

    def padded(x):
        return torch.cat([x, x.new_zeros(pad)]) if pad else x

    # A trailing edge in the pad would land at >= t_len and is masked by
    # `closed`: a pulse open at capture end is never emitted.
    n_b = (t_len + pad) // block
    lead_b = padded(lead).reshape(n_b, block)
    trail_b = padded(trail).reshape(n_b, block)
    mag_b = padded(mag).reshape(n_b, block)
    sat_b = padded(sat.to(torch.float32)).reshape(n_b, block)
    ranks = torch.arange(1, max_pulses + 1, dtype=torch.float32, device=dev)
    pos = torch.arange(block, dtype=torch.float32, device=dev)

    def rank_positions(bits_b):
        """Index of the r-th set bit (r = 1..max_pulses), ``t_len`` when
        absent: block-end cumsum compare, then one partial block."""
        bcum = torch.cumsum(bits_b.sum(dim=1), 0)  # (n_b,) inclusive
        full = (bcum[None, :] < ranks[:, None]).sum(dim=1)
        idx = full.clamp(max=n_b - 1)
        part = bits_b[idx]  # (R, block)
        base = torch.where(idx > 0, bcum[(idx - 1).clamp(min=0)],
                           torch.zeros((), device=dev))
        lc = torch.cumsum(part, dim=1)
        within = (lc < (ranks - base)[:, None]).sum(dim=1)
        return torch.clamp(idx * block + within, max=t_len).to(torch.int32)

    toa_idx = rank_positions(lead_b)
    te_idx = rank_positions(trail_b)
    closed = (toa_idx < t_len) & (te_idx < t_len)
    count = torch.clamp(trail.sum(), max=max_pulses).to(torch.int32)
    valid = (torch.arange(max_pulses, device=dev) < count) & closed

    def span_fn(vals_b):
        """``(p0, p1) -> sum(vals[p0:p1])``: the block partials' prefix
        plus one gathered block at each end.  The prefix over blocks is
        float64: in float32 its ulp at a dwell's running sum (0.002 at 4.48
        M samples) is a part in 10^4 of a short pulse's sum, and the
        difference of two prefixes would carry it."""
        bsum_ex = torch.cat([
            torch.zeros(1, dtype=torch.float64, device=dev),
            torch.cumsum(vals_b.sum(dim=1).to(torch.float64), 0)[:-1]])

        def at(p):
            blk = torch.clamp(p // block, max=n_b - 1).to(torch.int64)
            within = (p - blk * block).to(torch.float32)
            rows = torch.where(pos[None, :] < within[:, None], vals_b[blk],
                               torch.zeros((), device=dev))
            return bsum_ex[blk], rows.sum(dim=1)

        def span(p0, p1):
            (b0, r0), (b1, r1) = at(p0), at(p1)
            return (b1 - b0).to(torch.float32) + (r1 - r0)
        return span

    safe_toa = torch.clamp(toa_idx, max=t_len - 1)
    safe_te = torch.clamp(te_idx, max=t_len - 1)
    amp = span_fn(mag_b)(safe_toa, safe_te) / torch.clamp(
        (safe_te - safe_toa).to(torch.float32), min=1.0)
    # interior samples toa+1 .. te-1 (both edge samples excluded)
    sat_cnt = span_fn(sat_b)(torch.clamp(safe_toa + 1, max=t_len - 1),
                             safe_te)
    snr = 10.0 * torch.log10(amp / noise_floor)

    zero = torch.zeros((), device=dev)
    return PdwBatch(
        toa_idx=torch.where(valid, toa_idx, -1),
        te_idx=torch.where(valid, te_idx, -1),
        pw_sec=torch.where(valid, (te_idx - toa_idx).to(torch.float32), zero),
        mag=torch.where(valid, amp, zero),
        snr_db=torch.where(valid, snr, zero),
        freq_offset_hz=torch.zeros(max_pulses, device=dev),
        saturated=valid & (sat_cnt > 0.5),
        valid=valid,
        count=count,
    )


def _event_streams(mag, sat, cfg: PdwConfig, noise_floor):
    if noise_floor is None:
        noise_floor = mag.mean()
    return _extract_event_core(mag, sat, noise_floor, cfg.snr_threshold_db,
                               cfg.max_pulses)


def extract_pdws_event(
    iq: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
) -> PdwBatch:
    """Wideband event-mode extraction from a complex capture: the mean
    noise floor (``usrp_predict_event.cpp:288-289``) and
    :func:`_extract_event_core`.  The real-time tracker's extraction."""
    mag = iq.abs()
    sat = ((iq.real.abs() >= cfg.saturation_level)
           | (iq.imag.abs() >= cfg.saturation_level))
    return _event_streams(mag, sat, cfg, noise_floor)


def extract_pdws_event_planes(
    yr: torch.Tensor,
    yi: torch.Tensor,
    cfg: PdwConfig,
    noise_floor: Optional[torch.Tensor] = None,
) -> PdwBatch:
    """:func:`extract_pdws_event` from two float planes."""
    mag = torch.sqrt(yr * yr + yi * yi)
    sat = (yr.abs() >= cfg.saturation_level) | (yi.abs() >= cfg.saturation_level)
    return _event_streams(mag, sat, cfg, noise_floor)


def finalize_pdws(
    batch: PdwBatch,
    fs: float,
    fc: float = 0.0,
    sample_start_time: float = 0.0,
    bin_offsets_hz: Optional[np.ndarray] = None,
) -> dict:
    """Convert a (possibly channelized) PdwBatch, of tensors or of NumPy
    arrays, to host float64 PDW arrays.

    Applies the MATLAB formulas exactly, in float64:
    ``toa = (i0+1)/fs + sampleStartTime``, ``pw = (jj-toa)/fs``,
    ``freq = fc [+ bin] + fs*medPhaseDiff/360``.  For channelized batches
    pass ``bin_offsets_hz = center_frequencies(M, fs_original)`` and the
    decimated ``fs``.

    Returns a dict of 1-D numpy arrays sorted by TOA:
    ``toa, freq, pw, mag, snr, sat, channel``.
    """
    def host(x, dtype):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype)

    toa_idx = host(batch.toa_idx, np.int64)
    te_idx = host(batch.te_idx, np.int64)
    valid = host(batch.valid, bool)
    mag = host(batch.mag, np.float64)
    snr = host(batch.snr_db, np.float64)
    foff = host(batch.freq_offset_hz, np.float64)
    sat = host(batch.saturated, bool)

    if toa_idx.ndim == 1:
        channel = np.zeros_like(toa_idx)
        bin_off = np.zeros(1)
    else:
        m = toa_idx.shape[0]
        channel = np.broadcast_to(np.arange(m)[:, None], toa_idx.shape)
        bin_off = (np.zeros(m) if bin_offsets_hz is None
                   else np.asarray(bin_offsets_hz, np.float64))

    sel = valid.ravel()
    ch = channel.ravel()[sel]
    i0 = toa_idx.ravel()[sel]
    i1 = te_idx.ravel()[sel]
    toa = (i0 + 1) / fs + sample_start_time
    pw = (i1 - i0) / fs
    freq = fc + bin_off[ch] + foff.ravel()[sel] * fs

    order = np.argsort(toa, kind="stable")
    return {
        "toa": toa[order],
        "freq": freq[order],
        "pw": pw[order],
        "mag": mag.ravel()[sel][order],
        "snr": snr.ravel()[sel][order],
        "sat": sat.ravel()[sel][order],
        "channel": ch[order],
    }
