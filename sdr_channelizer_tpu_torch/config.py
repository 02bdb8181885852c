"""Typed configuration of the port (the JAX package's names and defaults).

Every config of the JAX package: ``ChannelizerConfig``, ``PdwConfig``,
``EventConfig``, ``CaptureConfig``, ``GainSearchConfig``,
``SpectrogramConfig``, ``ShardingConfig`` and ``PipelineConfig``.  There are
no static-shape knobs:
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


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Event prediction configuration (``matlab/predict_event.m``).

    * quadratic fit of PDW SNR vs TOA; event time = parabola peak
      (``predict_event.m:125-130``; ``usrp_predict_event.cpp:28-52``)
    * next event = last event + median(diff(events)); bootstrap period used
      before >=2 events exist (``predict_event.m:134-138``)
    * a capture participates only if max |iq| > amplitude_gate
      (``predict_event.m:53``)
    * the real-time tracker requires min_pulses_for_fit pulses
      (``usrp_predict_event.cpp:348``) and min_events_for_pri events
      (``usrp_predict_event.cpp:354``)
    """

    amplitude_gate: float = 0.9
    bootstrap_period_sec: float = 4.61962892466417  # predict_event.m:137
    min_pulses_for_fit: int = 10  # usrp_predict_event.cpp:348
    min_events_for_pri: int = 5  # usrp_predict_event.cpp:354


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """The reference recorders' 7-positional-argument CLI contract
    (``blade_record_iq_12bit.cpp:31-48``, ``usrp_record_iq_12bit.cpp:24-30``).
    """

    frequency_mhz: float
    bandwidth_mhz: float
    sample_rate_msps: float
    rx_gain_db: float
    dwell_sec: float
    duration_sec: float
    filter_delay_samples: int = 0
    bit_width: int = 12

    @property
    def sample_rate_sps(self) -> float:
        return self.sample_rate_msps * 1e6

    @property
    def dwell_samples(self) -> int:
        return int(round(self.dwell_sec * self.sample_rate_sps))


@dataclasses.dataclass(frozen=True)
class GainSearchConfig:
    """Max-unsaturated-gain search (``blade_find_max_unsaturated_gain.cpp``):
    receive a dwell, scan for any sample >= saturation_fraction * full scale,
    decrement gain by gain_step_db and repeat until duration elapses
    (``:227-274``)."""

    saturation_fraction: float = 0.98
    gain_step_db: float = 1.0


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """STFT configuration matching ``spectrogram_my_iq.m:114``:
    hamming(768) symmetric window, zero overlap, squared-magnitude power,
    frequency axis centered on fc."""

    window_length: int = 768
    overlap: int = 0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """2-D (time-blocks x channels) mesh layout for long captures
    (``parallel``).

    The sample axis is sharded into time blocks with overlap-save FIR halos
    exchanged between neighbours, the channel axis is sharded for PDW
    extraction, and boundary-straddling pulses are emitted once, by the
    shard that owns their leading edge (each shard reads
    ``pdw_halo_frames`` frames past its right boundary).

    Kept for the JAX package's names and defaults: no code of either
    package reads it.  ``ShardedPipeline`` takes its halo from its own
    ``halo_frames`` (default ``PdwConfig.max_pulse_samples``).
    """

    time_axis: str = "time"
    channel_axis: str = "chan"
    # Right-halo length (decimated frames) for cross-boundary pulse capture;
    # must be >= PdwConfig.max_pulse_samples for exact boundary stitching.
    pdw_halo_frames: int = 4096


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config for the channelize -> PDW -> predict pipeline.
    Kept for the JAX package's names and defaults: no code of either
    package reads it."""

    channelizer: ChannelizerConfig
    pdw: PdwConfig = dataclasses.field(default_factory=PdwConfig.channelized)
    events: EventConfig = dataclasses.field(default_factory=EventConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
