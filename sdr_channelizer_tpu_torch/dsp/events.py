"""Event prediction: L6 of the reference stack.

Semantics (``matlab/predict_event.m``; C++ twin
``cpp/usrp_predict_event.cpp:28-52,348-373``):

* Per capture, fit a quadratic to PDW SNR vs TOA; the event time is the
  parabola peak ``t* = -p1 / (2 p2)`` (``predict_event.m:125-130``).
* The next event is ``last_event + median(diff(events))`` once more than one
  event exists; before that a bootstrap period constant is used
  (``predict_event.m:134-138``; the reference hard-codes
  4.61962892466417 s).
* A capture participates only when ``max|iq| > 0.9``
  (``predict_event.m:53``).
* The real-time C++ tracker requires > 10 pulses before fitting
  (``usrp_predict_event.cpp:348``) and > 5 events before predicting the PRI
  (``:354``), and schedules the next dwell at ``next_event - dwell/2``
  (``:229-241``).

The host functions fit in float64 (Vandermonde least squares, as MATLAB and
Eigen).  :func:`quadratic_peak_time_masked` is the tracker's fit on the
device: float32, on TOAs *relative to the capture start* (absolute epoch
seconds do not fit a float32), a closed-form 3x3 solve.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch.config import EventConfig


def quadratic_peak_time(toa: np.ndarray, snr: np.ndarray) -> float:
    """Host f64 quadratic LSQ fit of snr(toa); returns the parabola peak time.

    Equivalent to ``polyfit(toa, snr, 2)`` + ``-p2/(2 p1)``
    (``predict_event.m:125-130``) and to the Eigen householderQr fit
    (``usrp_predict_event.cpp:28-52``).  Requires >= 3 points.
    """
    t = np.asarray(toa, np.float64)
    v = np.asarray(snr, np.float64)
    if t.size != v.size or t.size < 3:
        raise ValueError("need >= 3 (toa, snr) pairs")
    # Center for conditioning; the peak location is shift-equivariant.
    t0 = t.mean()
    p2, p1, _ = np.polyfit(t - t0, v, 2)
    if p2 == 0.0:
        return float("nan")
    return float(t0 - p1 / (2.0 * p2))


def quadratic_peak_time_masked(
    toa: torch.Tensor, snr: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Masked quadratic-peak fit on the device (float32; TOAs relative).

    Solves the 3x3 normal equations over the valid subset in closed form
    (Cramer), in the JAX package's operation order; returns NaN when fewer
    than 3 valid points or a degenerate quadratic.  A 0-dim tensor: no host
    sync.
    """
    w = valid.to(torch.float32)
    n = w.sum()
    tmean = (toa * w).sum() / torch.clamp(n, min=1.0)
    t = (toa - tmean) * w
    v = snr * w
    tt = t * t
    s0, s1 = n, t.sum()
    s2, s3, s4 = tt.sum(), (tt * t).sum(), (tt * tt).sum()
    b0, b1, b2 = v.sum(), (t * v).sum(), (tt * v).sum()
    det = (s0 * (s2 * s4 - s3 * s3) - s1 * (s1 * s4 - s2 * s3)
           + s2 * (s1 * s3 - s2 * s2))
    # only p1, p2 are needed for the peak -p1/(2 p2)
    p1 = (s0 * (b1 * s4 - s3 * b2) - s1 * (b0 * s4 - s2 * b2)
          + s2 * (b0 * s3 - s2 * b1)) / det
    p2 = (s0 * (s2 * b2 - b1 * s3) - s1 * (s1 * b2 - b0 * s3)
          + s2 * (s1 * b1 - b0 * s2)) / det
    peak = tmean - p1 / (2.0 * p2)
    bad = (n < 3) | (p2 == 0.0) | (det == 0.0)
    return torch.where(bad, torch.full((), float("nan"), device=peak.device),
                       peak)


def next_event_time(
    events: Sequence[float], cfg: EventConfig = EventConfig()
) -> float:
    """``median(diff(events)) + events[-1]``; bootstrap period before two
    events exist (``predict_event.m:134-138``)."""
    ev = np.asarray(events, np.float64)
    if ev.size == 0:
        raise ValueError("no events")
    if ev.size == 1:
        return float(ev[-1] + cfg.bootstrap_period_sec)
    return float(np.median(np.diff(ev)) + ev[-1])


@dataclasses.dataclass
class EventPredictor:
    """Stateful offline predictor: feed per-capture PDW lists, get the
    evolving next-event estimate (the ``predict_event.m`` driver loop)."""

    cfg: EventConfig = dataclasses.field(default_factory=EventConfig)
    events: List[float] = dataclasses.field(default_factory=list)
    fits: List[Tuple[float, float]] = dataclasses.field(default_factory=list)

    def update(
        self,
        toa: np.ndarray,
        snr: np.ndarray,
        max_abs_iq: Optional[float] = None,
    ) -> Optional[float]:
        """Process one capture's PDWs; returns the next-event prediction or
        None when the capture is gated out / has too few pulses."""
        if max_abs_iq is not None and max_abs_iq <= self.cfg.amplitude_gate:
            return None
        toa = np.asarray(toa, np.float64)
        if toa.size < 3:
            return None
        t_max = quadratic_peak_time(toa, snr)
        if not np.isfinite(t_max):
            return None
        y_max = float(np.polyval(np.polyfit(toa - toa.mean(), snr, 2),
                                 t_max - toa.mean()))
        self.events.append(t_max)
        self.fits.append((t_max, y_max))
        return next_event_time(self.events, self.cfg)
