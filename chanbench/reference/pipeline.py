"""Raw payload -> host PDW dict, plainly: dequantise, channelize (the
branch FIR, then the fftshift-ordered DFT as a product), the detection
streams, the exact median floor, the latch and the per-pulse medians, then
the float64 finalize.  See the package docstring for ``precision``."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from chanbench.reference import filters
from chanbench.reference import pdw as rpdw

RAD2DEG = 180.0 / np.pi
# a sample within this share of a threshold (or of the saturation level)
# decides an edge (a flag) by rounding
EDGE_GUARD = 1e-3


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def channelize(xr: torch.Tensor, xi: torch.Tensor, cfg: dict,
               precision: str):
    """(N,) float32 planes -> (T, M) band planes ``yr``, ``yi``."""
    m = int(cfg["num_bands"])
    h = filters.frame_taps(filters.prototype(
        m, cfg["taps_per_band"], cfg["stopband_atten_db"]), m)
    taps = torch.as_tensor(np.ascontiguousarray(h, np.float32),
                           device=xr.device)
    p = taps.shape[0]
    t = xr.shape[0] // m
    branches = []
    for plane in (xr, xi):
        frames = plane[: t * m].reshape(t, m)
        padded = torch.cat([frames.new_zeros((p - 1, m)), frames])
        u = torch.zeros_like(frames)
        for k in range(p):
            u = u + taps[k] * padded[p - 1 - k: p - 1 - k + t]
        branches.append(u)
    rho = np.arange(m)[:, None]
    w = np.exp(-2j * np.pi * rho * np.arange(m)[None, :] / m)
    w = w[:, np.fft.fftshift(np.arange(m))]
    wr = torch.as_tensor(w.real.astype(np.float32), device=xr.device)
    wi = torch.as_tensor(w.imag.astype(np.float32), device=xr.device)
    ur, ui = branches
    if precision == "tf32":
        ur, ui, wr, wi = (_round_tf32(v) for v in (ur, ui, wr, wi))
    yr = ur @ wr - ui @ wi
    yi = ur @ wi + ui @ wr
    return yr, yi


def streams(yr: torch.Tensor, yi: torch.Tensor, cfg: dict, precision: str):
    """Magnitude, phase in degrees and the saturation mask, time last."""
    if precision == "bfloat16":
        yr, yi = _round_bf16(yr), _round_bf16(yi)
    mag = torch.sqrt(yr * yr + yi * yi)
    if precision == "bfloat16":
        mag = _round_bf16(mag)
    ph = torch.atan2(yi, yr) * RAD2DEG
    level = float(cfg["saturation_level"])
    sat = (yr.abs() >= level) | (yi.abs() >= level)
    if mag.ndim == 2:
        mag, ph, sat = (v.T.contiguous() for v in (mag, ph, sat))
    return mag, ph, sat


def pdws(cfg: dict, payloads: List[np.ndarray], start_time: float,
         precision: str = "float32", block_frames: Optional[int] = None,
         device="cpu") -> dict:
    """The PDWs of the dwells ``payloads`` ((N, 2) int16 each, contiguous
    in time, the first starting at ``start_time``).  ``block_frames`` gives
    the streamed path's contract (slots a block, the look-ahead of
    ``max_pulse_samples`` frames); without it the capture is one shot."""
    if precision not in ("float32", "tf32", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _pdws(cfg, payloads, start_time, precision, block_frames,
                         torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _pdws(cfg, payloads, start_time, precision, block_frames, device):
    raw = np.concatenate(payloads) if len(payloads) > 1 else payloads[0]
    x = torch.as_tensor(np.ascontiguousarray(raw)).to(device)
    scale = 1.0 / 2 ** (int(cfg["bit_width"]) - 1)
    xr = x[:, 0].to(torch.float32) * scale
    xi = x[:, 1].to(torch.float32) * scale
    del x
    fs = float(cfg["sample_rate_sps"])
    fc = float(cfg["center_frequency_hz"])
    if cfg["kind"] == "wideband":
        sat_cs = _sat_guard(xr, xi, cfg)
        mag, ph, sat = streams(xr, xi, cfg, precision)
        nf = rpdw.median(mag)
        batch = rpdw.extract_core(mag, ph, sat, nf, cfg)
        return _with_guard(rpdw.finalize(batch, fs, fc, start_time), mag, nf,
                           cfg, sat_cs)
    m = int(cfg["num_bands"])
    yr, yi = channelize(xr, xi, cfg, precision)
    del xr, xi
    sat_cs = _sat_guard(yr, yi, cfg)
    mag, ph, sat = streams(yr, yi, cfg, precision)
    del yr, yi
    nf = rpdw.median(mag, dim=1)
    bins = np.fft.fftshift(np.fft.fftfreq(m)) * fs
    if block_frames is None:
        batch = rpdw.extract_core(mag, ph, sat, nf, cfg)
        out = rpdw.finalize(batch, fs / m, fc, start_time, bins)
    else:
        batches, offsets = rpdw.extract_blocks(mag, ph, sat, nf, cfg,
                                               int(block_frames))
        out = rpdw.finalize(rpdw.merge(batches, offsets), fs / m, fc,
                            start_time, bins)
    return _with_guard(out, mag, nf, cfg, sat_cs)


def _running_count(mask: torch.Tensor) -> np.ndarray:
    """(bands, T) -> (bands, T + 1): the count of set samples before each."""
    cs = torch.cumsum(mask.to(torch.int32), dim=1)
    return torch.cat([cs.new_zeros((cs.shape[0], 1)), cs], 1).cpu().numpy()


def _sat_guard(yr: torch.Tensor, yi: torch.Tensor, cfg: dict) -> tuple:
    """The running counts, (bands, T + 1), of the samples whose larger
    component lies within ``EDGE_GUARD`` of the saturation level, and of
    those clearly over it: a pulse with the first and none of the second
    inside it has a flag that float32's rounding may turn either way."""
    level = float(cfg["saturation_level"])
    v = torch.maximum(yr.abs(), yi.abs())
    v = v.T if v.ndim == 2 else v.reshape(1, -1)
    near = (v - level).abs() <= EDGE_GUARD * level
    clear = v > level * (1.0 + EDGE_GUARD)
    return _running_count(near), _running_count(clear)


def _with_guard(out: dict, mag: torch.Tensor, nf: torch.Tensor,
                cfg: dict, sat_cs: tuple) -> dict:
    """``out`` with ``edge_guard_cs``: a band's running count of the samples
    within ``EDGE_GUARD`` of a threshold, (bands, T + 1), whose latch
    decision float32's rounding may turn either way; and with
    ``sat_near_cs`` and ``sat_clear_cs`` (``_sat_guard``)."""
    lead, trail = rpdw.thresholds(nf, cfg)
    mag = mag.reshape(-1, mag.shape[-1])
    lead, trail = lead.reshape(-1, 1), trail.reshape(-1, 1)
    near = (((mag - lead).abs() <= EDGE_GUARD * lead)
            | ((mag - trail).abs() <= EDGE_GUARD * trail))
    out["edge_guard_cs"] = _running_count(near)
    out["sat_near_cs"], out["sat_clear_cs"] = sat_cs
    return out
