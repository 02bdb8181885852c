"""Prototype lowpass of the polyphase filterbank: a Kaiser-windowed sinc
of M * taps_per_band taps, cutoff at half the channel spacing, unit DC gain
(a frozen copy of the port's ``ops/filters.py``, itself the equivalent of
MATLAB's ``designMultirateFIR(1, M, 12, 80)``)."""

from __future__ import annotations

import numpy as np


def kaiser_beta(stopband_atten_db: float) -> float:
    a = stopband_atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def prototype(num_bands: int, taps_per_band: int,
              stopband_atten_db: float) -> np.ndarray:
    m = int(num_bands)
    n_taps = m * int(taps_per_band)
    n = np.arange(n_taps, dtype=np.float64)
    h = np.sinc((n - (n_taps - 1) / 2.0) / m) / m
    h = h * np.kaiser(n_taps, kaiser_beta(stopband_atten_db))
    return h / np.sum(h)


def frame_taps(h: np.ndarray, num_bands: int) -> np.ndarray:
    """``Hr[p, rho] = h[p M + (M - 1 - rho)]``: branch ``rho`` filters frame
    column ``rho``; output row n consumes input frame n fully."""
    return h.reshape(-1, num_bands)[:, ::-1]
