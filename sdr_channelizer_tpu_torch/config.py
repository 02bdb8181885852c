"""Typed configuration of the port (the JAX package's names and defaults).

Only the configs the ported slice needs live here so far:
``ChannelizerConfig`` and ``PdwConfig``.  There are no static-shape knobs:
PyTorch runs eagerly, so ``max_pulses`` / ``max_pulse_samples`` are plain
capacity bounds of the emitted batch, not compile-time shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChannelizerConfig:
    """Polyphase analysis filterbank configuration.

    Matches MATLAB ``dsp.Channelizer(num_bands)`` as the reference uses it
    (``matlab/create_pdws_channelized.m:31-33``): ``num_bands`` channels of
    width ``fs / num_bands``, a lowpass prototype with ``taps_per_band`` taps
    per polyphase branch and ``stopband_atten_db`` stopband attenuation,
    outputs decimated to ``fs / num_bands`` and centred with ``fftshift``.
    """

    num_bands: int
    taps_per_band: int = 12
    stopband_atten_db: float = 80.0

    @property
    def num_taps(self) -> int:
        return self.num_bands * self.taps_per_band


def bands_for_bin_width(sample_rate_sps: float, bin_width_hz: float = 1e6) -> int:
    """Number of channelizer bands for a target bin width (the reference
    uses ``M = fs*1e-6``, ``create_pdws_channelized.m:31``)."""
    return int(round(sample_rate_sps / bin_width_hz))


@dataclasses.dataclass(frozen=True)
class PdwConfig:
    """Pulse-descriptor-word extraction configuration.

    Reference semantics (``matlab/create_pdws.m:41-105``):

    * noise floor = median magnitude;
    * leading edge:  mag >= floor * 10^(snr_threshold_db/10);
    * trailing edge: mag <= floor * 10^(trailing_threshold_db/10);
      ``None`` means no hysteresis (trailing == leading threshold), as in the
      channelized extractor (``create_pdws_channelized.m:88-94``);
    * saturation flag: any |I| or |Q| >= saturation_level strictly inside the
      pulse (``create_pdws.m:100-102``).

    The extractor emits at most ``max_pulses`` PDWs per channel and measures
    the median statistics over at most ``max_pulse_samples`` samples of each
    pulse.
    """

    snr_threshold_db: float = 18.0
    trailing_threshold_db: Optional[float] = 3.0
    saturation_level: float = 0.9999
    max_pulses: int = 512
    max_pulse_samples: int = 4096

    @classmethod
    def wideband(cls, **kw) -> "PdwConfig":
        """18 dB leading / 3 dB trailing (``create_pdws.m:45-47``)."""
        return cls(snr_threshold_db=18.0, trailing_threshold_db=3.0, **kw)

    @classmethod
    def channelized(cls, **kw) -> "PdwConfig":
        """15 dB, no hysteresis (``create_pdws_channelized.m:74``)."""
        return cls(snr_threshold_db=15.0, trailing_threshold_db=None, **kw)

    @classmethod
    def event(cls, **kw) -> "PdwConfig":
        """20 dB, no hysteresis (``predict_event.m:65-66``)."""
        return cls(snr_threshold_db=20.0, trailing_threshold_db=None, **kw)
