"""Synthetic pulse-train / LFM / Barker-13 I/Q generators.

These are the framework's ground-truth fixtures, reproducing the semantics of
the reference generators:

* ``generate_training_iq.m``: random CW frequency in (-fs/2, fs/2), random
  PW in [10, 1000] us, random PRI in [max(10us, PW), 10000 us], random start
  index within one PRI, unit-magnitude rectangular pulses with a
  phase-accumulator tone, written as a v1 ``.iq`` file with int16 samples and
  ``boardName = "simulated"`` (``:12-26, :42-62, :107-127``).
* ``generate_pulsed_iq.m``: deterministic PW = 100 us / PRI = 1 ms at
  56 Msps, optional LFM chirp (``linspace`` frequency + ``cumsum`` phase,
  ``:43-47``) and optional 13-chip Barker BPSK with +/-90 degree chip phases
  (``:49-59``).

Pulse placement rule (both generators): a pulse is written only when it fits
entirely before the end of the capture (``generate_training_iq.m:52-55``);
pulses repeat every PRI from the start index.

Generation is NumPy (host-side, file-producing fixtures), vectorized — no
per-sample Python loops.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from sdr_channelizer_tpu_torch.io import iqpacket

#: Barker-13 code chip signs (reference encodes it as +/-90 degree phase
#: segments of lengths 5,2,2,1,1,1,1 chips, ``generate_pulsed_iq.m:50-56``).
_BARKER13_SEGMENTS = [(5, +90.0), (2, -90.0), (2, +90.0), (1, -90.0),
                      (1, +90.0), (1, -90.0), (1, +90.0)]


@dataclasses.dataclass(frozen=True)
class PulseTrainSpec:
    """Ground truth for one synthetic capture."""

    sample_rate_sps: float = 56e6
    duration_sec: float = 10e-3
    frequency_hz: float = 1e6
    pulse_width_sec: float = 100e-6
    pri_sec: float = 1000e-6
    start_index: int = 0  # 0-based sample index of the first pulse
    lfm_extent_hz: float = 0.0
    barker13: bool = False
    amplitude: float = 1.0
    noise_std: float = 0.0

    @property
    def num_samples(self) -> int:
        return int(round(self.sample_rate_sps * self.duration_sec))

    @property
    def pw_samples(self) -> int:
        return int(round(self.sample_rate_sps * self.pulse_width_sec))

    @property
    def pri_samples(self) -> int:
        return int(round(self.sample_rate_sps * self.pri_sec))


def barker13_phase(pw_samples: int) -> np.ndarray:
    """Per-sample Barker-13 phase offsets in radians.

    ``pw_samples`` must be a multiple of 13 (the reference rounds the pulse
    width to 13 equal chips, ``generate_pulsed_iq.m:34-40``).
    """
    if pw_samples % 13:
        raise ValueError("Barker-13 pulse width must be a multiple of 13 samples")
    per_chip = pw_samples // 13
    segs = [np.full(n * per_chip, np.deg2rad(deg)) for n, deg in _BARKER13_SEGMENTS]
    return np.concatenate(segs)


def _single_pulse_phase(spec: PulseTrainSpec) -> np.ndarray:
    """Phase profile (radians) of one pulse, reference accumulator semantics.

    CW (``generate_training_iq.m:44-50``): phi[0] = 0,
    phi[n] = phi[n-1] + 2*pi*f/fs — i.e. an exclusive cumsum.
    LFM (``generate_pulsed_iq.m:43-47``): f sweeps linspace(f0, f1, PW) and
    phi = *inclusive* cumsum of 2*pi*f/fs.
    """
    fs = spec.sample_rate_sps
    n = spec.pw_samples
    if spec.lfm_extent_hz:
        f = np.linspace(
            spec.frequency_hz, spec.frequency_hz + spec.lfm_extent_hz, n
        )
        phi = np.cumsum(2 * np.pi * f / fs)
    else:
        phi = 2 * np.pi * spec.frequency_hz / fs * np.arange(n, dtype=np.float64)
    if spec.barker13:
        phi = phi + barker13_phase(n)
    # angle(exp(1j*phi)) wrap, as the reference does before use
    return np.angle(np.exp(1j * phi))


def pulse_train(spec: PulseTrainSpec, seed: Optional[int] = None) -> np.ndarray:
    """Generate the complex64 pulse train for ``spec``.

    Vectorized equivalent of the reference per-PRI fill loops
    (``generate_training_iq.m:40-62``): unit-magnitude rectangular pulses at
    ``start_index + k*pri_samples`` for every pulse that fits entirely within
    the capture; identical phase profile per pulse.
    """
    n_total = spec.num_samples
    pw = spec.pw_samples
    pri = spec.pri_samples
    iq = np.zeros(n_total, dtype=np.complex128)

    phase = _single_pulse_phase(spec)
    pulse = spec.amplitude * np.exp(1j * phase)

    # Reference placement: pulse written iff idx + pw < n_total (strict).
    starts = np.arange(spec.start_index, n_total, pri)
    starts = starts[starts + pw < n_total]
    if len(starts):
        idx = (starts[:, None] + np.arange(pw)[None, :]).ravel()
        iq[idx] = np.tile(pulse, len(starts))

    if spec.noise_std > 0:
        rng = np.random.default_rng(seed)
        iq = iq + spec.noise_std * (
            rng.standard_normal(n_total) + 1j * rng.standard_normal(n_total)
        ) / np.sqrt(2)
    return iq.astype(np.complex64)


def pulse_starts(spec: PulseTrainSpec) -> np.ndarray:
    """0-based start sample of every emitted pulse (ground truth for tests)."""
    starts = np.arange(spec.start_index, spec.num_samples, spec.pri_samples)
    return starts[starts + spec.pw_samples < spec.num_samples]


def random_pulse_train_spec(
    seed: int, sample_rate_sps: float = 56e6, duration_sec: float = 100e-3
) -> PulseTrainSpec:
    """Randomized spec with the reference's distributions
    (``generate_training_iq.m:12-26``)."""
    rng = np.random.default_rng(seed)
    fs = sample_rate_sps
    f = -(fs / 2) + fs * rng.random()
    min_pw, max_pw = 10e-6, 1000e-6
    pw = min_pw + (max_pw - min_pw) * rng.random()
    min_pri = max(10e-6, pw)
    max_pri = 10000e-6
    pri = min_pri + (max_pri - min_pri) * rng.random()
    start_idx = int(rng.integers(1, int(round(pri * fs)) + 1))
    return PulseTrainSpec(
        sample_rate_sps=fs,
        duration_sec=duration_sec,
        frequency_hz=f,
        pulse_width_sec=pw,
        pri_sec=pri,
        start_index=start_idx,
    )


def write_training_iq(
    path,
    spec: PulseTrainSpec,
    bit_width: int = 16,
    file_format: int = 1,
    sample_start_time: Optional[float] = None,
    seed: Optional[int] = None,
) -> iqpacket.IqHeader:
    """Generate and write a training capture like ``generate_training_iq.m``.

    Defaults mirror the reference writer (``:107-127``): v1 format, int16
    samples, bandwidth = sample rate, gain 0, ``boardName = "simulated"``,
    sampleStartTime = now.
    """
    iq = pulse_train(spec, seed=seed)
    samples = iqpacket.from_complex(iq, bit_width)
    hdr = iqpacket.IqHeader(
        frequency_hz=0.0,
        bandwidth_hz=spec.sample_rate_sps,
        sample_rate_sps=spec.sample_rate_sps,
        rx_gain_db=0.0,
        num_samples=len(iq),
        bit_width=bit_width,
        sample_start_time=(
            time.time() if sample_start_time is None else sample_start_time
        ),
        link_speed=1,
        board_name="simulated",
        file_format=file_format,
    )
    iqpacket.write_iq(path, hdr, samples)
    return hdr
