"""Prototype lowpass filter design for the polyphase analysis filterbank.

MATLAB's ``dsp.Channelizer`` designs its prototype with
``designMultirateFIR(1, M, tapsPerBand, stopbandAtten)`` — a lowpass
anti-alias filter for decimate-by-M with ``M * tapsPerBand`` coefficients
(defaults: 12 taps/band, 80 dB stopband; reference usage at
``matlab/create_pdws_channelized.m:31-33``).  We use the classic
Kaiser-windowed-sinc equivalent: same length, same cutoff (half the channel
spacing), Kaiser beta chosen from the stopband attenuation by Kaiser's
formula.  This matches the MATLAB design in passband gain, cutoff, and
stopband floor — per-channel outputs agree within the filter's own SNR
bound, which is the parity contract (BASELINE.md), not bit-exactness.

Design is NumPy/f64 at setup time; only the resulting f32 taps go to the device.
"""

from __future__ import annotations

import numpy as np


def kaiser_beta(stopband_atten_db: float) -> float:
    """Kaiser window beta for a target stopband attenuation (Kaiser's formula)."""
    a = stopband_atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def design_prototype_filter(
    num_bands: int, taps_per_band: int = 12, stopband_atten_db: float = 80.0
) -> np.ndarray:
    """Lowpass prototype ``h`` of length ``num_bands * taps_per_band``.

    Cutoff at half the channel spacing (``fs / (2*M)``), unit DC gain
    (a full-scale tone at a channel center comes out at amplitude ~1, as in
    ``channelizer_example.m`` where the waterfall is scaled to [0, 1.5]).
    """
    m = int(num_bands)
    L = m * int(taps_per_band)
    if m < 1 or L < 1:
        raise ValueError("num_bands and taps_per_band must be positive")
    if m == 1:
        # Degenerate single-band case: pass-through.
        h = np.zeros(L or 1)
        h[0] = 1.0
        return h
    n = np.arange(L, dtype=np.float64)
    center = (L - 1) / 2.0
    # Ideal lowpass, cutoff pi/M rad/sample.
    ideal = np.sinc((n - center) / m) / m
    w = np.kaiser(L, kaiser_beta(stopband_atten_db))
    h = ideal * w
    return h / np.sum(h)


def polyphase_decompose(h: np.ndarray, num_bands: int) -> np.ndarray:
    """Polyphase matrix ``H[p, rho] = h[p*M + rho]`` of shape (P, M)."""
    L = len(h)
    m = int(num_bands)
    if L % m:
        raise ValueError(f"filter length {L} not a multiple of num_bands {m}")
    return h.reshape(L // m, m)


def reversed_polyphase(h: np.ndarray, num_bands: int) -> np.ndarray:
    """Frame-aligned polyphase matrix ``Hr[p, rho] = h[p*M + (M-1-rho)]``.

    This is the tap layout for the frame-convention channelizer (output row n
    consumes input frame n fully — the dsp.Channelizer System-object
    convention): branch ``rho`` filters frame column ``rho`` directly and the
    channel outputs are the forward DFT of the branch outputs.  See
    ``dsp/channelizer.py`` for the derivation.
    """
    return polyphase_decompose(h, num_bands)[:, ::-1]
