"""The comparison that decides ``correct``: a PDW dict of the program
against the reference's for the same dwells.

Pulses pair when their band, leading-edge sample, trailing-edge sample
and saturation flag are all equal: the exact fields.  Over the pairs the
float fields are compared by their widest gap.  The numbers:

* ``unpaired_pct``: the share, in %, of the two sides' pulses that find no
  pair (a count, a TOA, a width, a band or a flag that differs), an exact
  comparison.  A latch decision on a sample within
  ``reference.pipeline.EDGE_GUARD`` of a threshold is float32's rounding
  to make, so a pulse with such a sample from the one before its leading
  edge to its trailing edge (the reference's ``edge_guard_cs``) is left
  out, and so are, in a band (a band's block, streamed) whose slots are
  full, as many of its last pulses as it holds such pulses: one pulse more
  or less early on moves the last slot.  Both are counted on stderr.  The
  saturation flag is exact too, but a pulse with a sample strictly inside
  it within ``EDGE_GUARD`` of the saturation level, and none clearly over
  it, has a flag that rounding decides: its flag is not held, and such
  pairs are counted on stderr;
* ``mag_gap``: the widest relative gap of the median magnitude;
* ``snr_gap_db``: the widest gap of the SNR, which carries the band's
  noise floor;
* ``freq_gap_hz``: the widest gap of the frequency, taken around the circle
  of one band (or of the sample rate, wideband): the median phase
  difference is an angle.  The median of wrapped differences jumps where
  one of them crosses +-180 degrees, so a pulse whose reference window holds
  a difference within ``WRAP_GUARD_DEG`` of the cut (the reference's
  ``wrap_margin_deg``) has no frequency to hold to a gap; such pulses are
  counted on stderr.  The guard is five times the largest phase error the
  program showed against the reference on the card (0.41 degrees, a
  trailing-edge sample near the noise in ``ch56_dense``).

A NaN on both sides (a one-sample pulse has no phase difference) is no
gap; a NaN on one side is an infinite one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

NUMBERS = ("unpaired_pct", "mag_gap", "snr_gap_db", "freq_gap_hz")
WRAP_GUARD_DEG = 2.0


def _edges(d: dict, rate: float, start_time: float):
    i0 = np.rint((np.asarray(d["toa"]) - start_time) * rate).astype(
        np.int64) - 1
    te = i0 + np.rint(np.asarray(d["pw"]) * rate).astype(np.int64)
    return np.asarray(d["channel"], np.int64), i0, te


def _keys(d: dict, rate: float, start_time: float,
          unheld: np.ndarray) -> np.ndarray:
    """One int64 a pulse: band, leading edge, width and flag; the flag is
    cleared where ``unheld``."""
    ch, i0, te = _edges(d, rate, start_time)
    width = te - i0
    sat = (np.asarray(d["sat"], bool) & ~unheld).astype(np.int64)
    key = (((ch << 27) | i0) << 26) | (width << 1) | sat
    out = ((i0 < 0) | (i0 >= 1 << 27) | (width < 0) | (width >= 1 << 24)
           | (ch < 0) | (ch >= 1 << 9))
    # a pulse outside the key's range pairs with nothing
    return np.where(out, -1 - np.arange(len(key)), key)


def _gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    both = np.isnan(a) & np.isnan(b)
    g = np.abs(a - b)
    g = np.where(np.isnan(a) ^ np.isnan(b), np.inf, g)
    return np.where(both, 0.0, g)


def _guarded(d: dict, cs: np.ndarray, rate: float, start_time: float):
    """Whether each pulse of ``d`` has a sample near a threshold in
    ``[toa - 1, te]``."""
    ch, i0, te = _edges(d, rate, start_time)
    t_len = cs.shape[1] - 1
    ok = (ch >= 0) & (ch < cs.shape[0]) & (i0 >= 0) & (te < t_len) & (te >= i0)
    chs, lo, hi = (np.where(ok, v, 0) for v in (ch, np.maximum(i0 - 1, 0),
                                                 te + 1))
    return ok & (cs[chs, np.minimum(hi, t_len)] - cs[chs, lo] > 0)


def _flag_unheld(d: dict, ref: dict, rate: float, start_time: float,
                 window: Optional[int]) -> np.ndarray:
    """Whether each pulse of ``d`` has, strictly inside its first
    ``window`` frames, a sample within rounding of the saturation level
    and none clearly over it (the reference's ``sat_near_cs`` and
    ``sat_clear_cs``): its flag is float32's rounding to decide."""
    if "sat_near_cs" not in ref:
        return np.zeros(len(np.asarray(d["sat"])), bool)
    near, clear = ref["sat_near_cs"], ref["sat_clear_cs"]
    ch, i0, te = _edges(d, rate, start_time)
    t_len = near.shape[1] - 1
    hi = te if window is None else np.minimum(te, i0 + window - 1)
    ok = (ch >= 0) & (ch < near.shape[0]) & (i0 >= 0) & (hi > i0 + 1)
    chs = np.where(ok, ch, 0)
    lo = np.clip(np.where(ok, i0 + 1, 0), 0, t_len)
    hi = np.clip(np.where(ok, hi, 0), 0, t_len)
    return ok & (near[chs, hi] - near[chs, lo] > 0) & (
        clear[chs, hi] - clear[chs, lo] == 0)


def _capped_tail(d: dict, free: np.ndarray, guard: Dict[tuple, int],
                 slots: int, block: Optional[int], rate: float,
                 start_time: float) -> np.ndarray:
    """Each band's (band block's) last ``guard[group]`` pulses where the
    group's slots are full."""
    ch, i0, _ = _edges(d, rate, start_time)
    grp = i0 // block if block else np.zeros_like(i0)
    out = np.zeros(len(i0), bool)
    for (c, g), n in guard.items():
        idx = np.flatnonzero((ch == c) & (grp == g))
        if len(idx) >= slots:
            out[idx[np.argsort(i0[idx])][-n:]] = True
    return out & free


def numbers(prog: dict, ref: dict, rate: float, start_time: float,
            period_hz: float, slots: int,
            block: Optional[int] = None,
            window: Optional[int] = None) -> Dict[str, float]:
    """The comparison's numbers for one item; ``rate`` is the rate of the
    PDW indices (fs / M), ``period_hz`` the circle of ``freq``, ``slots``
    the PDWs a band (a band's block of ``block`` indices, streamed) holds,
    ``window`` the frames a pulse's statistics read (max_pulse_samples)."""
    up = _flag_unheld(prog, ref, rate, start_time, window)
    ur = _flag_unheld(ref, ref, rate, start_time, window)
    kp = _keys(prog, rate, start_time, up)
    kr = _keys(ref, rate, start_time, ur)
    if len(np.unique(kp)) != len(kp) or len(np.unique(kr)) != len(kr):
        raise ValueError("two pulses of one side share a band and edges")
    kr = np.where(kr < 0, kr - len(kp), kr)      # unpaired on both sides
    common, ip, ir = np.intersect1d(kp, kr, assume_unique=True,
                                    return_indices=True)
    total = len(kp) + len(kr)
    free_p = np.ones(len(kp), bool)
    free_p[ip] = False
    free_r = np.ones(len(kr), bool)
    free_r[ir] = False
    cs = ref["edge_guard_cs"]
    gp = _guarded(prog, cs, rate, start_time)
    gr = _guarded(ref, cs, rate, start_time)
    guard: Dict[tuple, int] = {}
    for d, g in ((prog, gp), (ref, gr)):
        ch, i0, _ = _edges(d, rate, start_time)
        grp = i0 // block if block else np.zeros_like(i0)
        for c, b in zip(ch[g], grp[g]):
            guard[(int(c), int(b))] = guard.get((int(c), int(b)), 0) + 1
    tail_p = _capped_tail(prog, free_p, guard, slots, block, rate, start_time)
    tail_r = _capped_tail(ref, free_r, guard, slots, block, rate, start_time)
    left_out = (free_p & (gp | tail_p)).sum() + (free_r & (gr | tail_r)).sum()
    unpaired = (free_p & ~gp & ~tail_p).sum() + (free_r & ~gr & ~tail_r).sum()
    out = {"unpaired_pct": float(100.0 * unpaired / max(total, 1)),
           "at_a_threshold": int(left_out),
           "flag_unheld": int(np.sum(ur[ir]))}
    if not len(common):
        out.update(mag_gap=0.0, snr_gap_db=0.0, freq_gap_hz=0.0, at_the_cut=0)
        return out

    def pick(d, key, idx):
        return np.asarray(d[key], np.float64)[idx]

    mr = pick(ref, "mag", ir)
    out["mag_gap"] = float(np.max(_gap(pick(prog, "mag", ip), mr)
                                  / np.maximum(np.abs(mr), 1e-30)))
    out["snr_gap_db"] = float(np.max(_gap(pick(prog, "snr", ip),
                                          pick(ref, "snr", ir))))
    df = _gap(pick(prog, "freq", ip), pick(ref, "freq", ir))
    df = np.where(np.isfinite(df), np.mod(df, period_hz), df)
    df = np.minimum(df, period_hz - df)
    held = pick(ref, "wrap_margin_deg", ir) >= WRAP_GUARD_DEG
    out["freq_gap_hz"] = float(np.max(df[held], initial=0.0))
    out["at_the_cut"] = int(np.sum(~held))
    return out


COUNTS = ("at_the_cut", "at_a_threshold", "flag_unheld")


def worst(a: Optional[Dict[str, float]], b: Dict[str, float]):
    """The larger of each number."""
    if a is None:
        return {k: b[k] for k in NUMBERS}
    return {k: max(a[k], b[k]) for k in NUMBERS}


def same(a: dict, b: dict) -> bool:
    """Whether two PDW dicts hold the same bits."""
    def eq(x, y):
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and x.dtype == y.dtype and np.array_equal(
            x, y, equal_nan=x.dtype.kind == "f")

    return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)


def verdict(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(found[k] <= limits[k] and not math.isnan(found[k])
               for k in limits)
