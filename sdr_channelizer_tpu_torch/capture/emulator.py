"""Emulated SDR receivers.

:class:`EmulatedRadio` is the in-process stand-in for the reference's
hardware receive path (``bladerf_sync_rx`` / ``rx_stream->recv`` dwells):
a deterministic pulse-train emitter with receiver gain modeled as amplitude
scaling that clips at the ADC full scale, timed dwells (the
``STREAM_MODE_NUM_SAMPS_AND_DONE`` analog, ``usrp_record_iq_12bit.cpp:
145-149``), and an optional scanning-beam envelope so SNR-vs-time traces a
parabola around periodic events: the signal model behind
``predict_event.m``'s quadratic fit.  It is NumPy on the host, and with the
same seed gives the JAX package's emulator's dwells bit for bit.

:class:`DeviceDwellEmitter` synthesises the same signal model on the device
as two float32 planes, so a closed-loop drive measures the extraction and
not NumPy.

:class:`NativeEmulator` wraps the C++ ``sdr_record_emulator`` binary
(``native/record_emulator.cc``), which writes real ``.iq`` files with the
recorders' CLI contract.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch.config import CaptureConfig
from sdr_channelizer_tpu_torch.utils.metrics import Counters


@dataclasses.dataclass
class EmulatedRadio:
    """Dwell-based receive emulator with absolute-time phase continuity.

    ``receive(n, start_time=None)`` returns ``(iq, t0)``: normalized
    complex64 samples (ADC-quantized, saturating at full scale) and the
    actual dwell start epoch.  A requested ``start_time`` in the future
    fast-forwards the stream (timed dwell); ``None`` receives "now" (i.e.,
    immediately after the previous dwell).
    """

    sample_rate_sps: float = 56e6
    tone_offset_hz: float = 5e6
    pulse_width_sec: float = 100e-6
    pri_sec: float = 1e-3
    rel_amplitude: float = 1.0
    noise_db: float = -60.0
    gain_ref_db: float = 60.0
    gain_db: float = 60.0
    bit_width: int = 12
    start_epoch: float = 0.0
    seed: int = 1234
    # Scanning-beam event model: SNR(dB) falls quadratically with distance
    # from the nearest event at k*scan_period + scan_phase (0 = no scan).
    scan_period_sec: float = 0.0
    scan_phase_sec: float = 0.0
    scan_curvature_db_per_s2: float = 0.0
    # The counters the reference prints as free-form stdout (received-sample
    # counts, overruns).
    counters: Counters = dataclasses.field(default_factory=Counters)

    def __post_init__(self):
        self._abs_index = 0
        self._rng = np.random.default_rng(self.seed)

    @property
    def full_scale(self) -> float:
        return float(2 ** (self.bit_width - 1))

    def _envelope_db(self, t: np.ndarray) -> np.ndarray:
        if self.scan_period_sec <= 0:
            return np.zeros_like(t)
        dt = (t - self.scan_phase_sec + self.scan_period_sec / 2) % self.scan_period_sec
        dt = dt - self.scan_period_sec / 2
        return -self.scan_curvature_db_per_s2 * dt * dt

    def receive(
        self, num_samples: int, start_time: Optional[float] = None
    ) -> Tuple[np.ndarray, float]:
        fs = self.sample_rate_sps
        idx = self._abs_index
        if start_time is not None:
            want = int(round((start_time - self.start_epoch) * fs))
            if want > idx:
                # Timed dwell in the future: the skipped span is data the
                # radio produced but nobody received, the emulator's overrun
                # analog (blade_record_iq_12bit.cpp:304-307).
                self.counters.add("samples_skipped", want - idx)
            idx = max(idx, want)
        k = idx + np.arange(num_samples, dtype=np.int64)
        t = k / fs
        pri_n = max(int(round(self.pri_sec * fs)), 1)
        pw_n = int(round(self.pulse_width_sec * fs))
        on = (k % pri_n) < pw_n
        if self.rel_amplitude > 0:
            amp_db = 20 * np.log10(self.rel_amplitude) + (self.gain_db - self.gain_ref_db)
            amp = 10.0 ** ((amp_db + self._envelope_db(t)) / 20.0)
        else:
            amp = np.zeros_like(t)
        ph = 2 * np.pi * self.tone_offset_hz / fs * (k % pri_n)
        sig = np.where(on, amp * np.exp(1j * ph), 0.0)
        nstd = 10.0 ** ((self.noise_db + self.gain_db - self.gain_ref_db) / 20.0)
        noise = nstd * (
            self._rng.standard_normal(num_samples)
            + 1j * self._rng.standard_normal(num_samples)
        ) / np.sqrt(2)
        raw = (sig + noise) * self.full_scale
        # ADC quantization with saturation (int16-style clip at full scale).
        fsc = self.full_scale
        i = np.clip(np.round(raw.real), -fsc, fsc - 1)
        q = np.clip(np.round(raw.imag), -fsc, fsc - 1)
        iq = ((i + 1j * q) / fsc).astype(np.complex64)
        ri, rq = np.round(raw.real), np.round(raw.imag)
        clipped = int(np.sum((ri > fsc - 1) | (ri < -fsc) | (rq > fsc - 1) | (rq < -fsc)))
        self.counters.add("dwells_received")
        self.counters.add("samples_received", num_samples)
        if clipped:
            self.counters.add("saturated_samples", clipped)
        self._abs_index = idx + num_samples
        return iq, self.start_epoch + idx / fs


@dataclasses.dataclass
class DeviceDwellEmitter:
    """Device-resident :class:`EmulatedRadio` twin: ``receive`` returns
    ``((xr, xi), t0)``, the dwell synthesised on ``device`` as two float32
    planes, so there is no host synthesis and no host-to-device copy.

    Same signal model and scheduling semantics as :class:`EmulatedRadio`
    (pulse train + scanning-beam envelope + gain-scaled amplitude + ADC
    round/clip at full scale).  The noise comes from a ``torch.Generator``
    on the device, seeded per dwell from ``seed`` and the dwell number, and
    the phase is float32, so samples differ from the host emulator's: it is
    a signal stand-in, not a codec.  Hand the planes tuple to
    :class:`~sdr_channelizer_tpu_torch.capture.tracker.EventTracker`, which
    takes it without a host copy.  ``device``: the CUDA device unless the
    caller asks for ``"cpu"``."""

    sample_rate_sps: float = 56e6
    tone_offset_hz: float = 5e6
    pulse_width_sec: float = 100e-6
    pri_sec: float = 1e-3
    rel_amplitude: float = 1.0
    noise_db: float = -60.0
    gain_ref_db: float = 60.0
    gain_db: float = 60.0
    bit_width: int = 12
    start_epoch: float = 0.0
    seed: int = 1234
    scan_period_sec: float = 0.0
    scan_phase_sec: float = 0.0
    scan_curvature_db_per_s2: float = 0.0
    # Optional second emitter (distinct PRI/tone, steady: no scan envelope),
    # the dense-environment / multi-emitter scenes; rel_amplitude2 = 0
    # disables it.
    tone2_offset_hz: float = 0.0
    pulse_width2_sec: float = 0.0
    pri2_sec: float = 1e-3
    rel_amplitude2: float = 0.0
    counters: Counters = dataclasses.field(default_factory=Counters)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._abs_index = 0
        self._dwell_no = 0
        fs = float(self.sample_rate_sps)
        self._pri_n = max(int(round(self.pri_sec * fs)), 1)
        self._pw_n = int(round(self.pulse_width_sec * fs))
        self._pri2_n = max(int(round(self.pri2_sec * fs)), 1)
        self._pw2_n = int(round(self.pulse_width2_sec * fs))
        self._gen = torch.Generator(device=self.device)

    @property
    def full_scale(self) -> float:
        return float(2 ** (self.bit_width - 1))

    def _dwell_seed(self, dwell_no: int) -> int:
        """The noise generator's seed for a dwell (what ``fold_in`` of the
        seed and the dwell number is in the JAX package)."""
        return int(np.random.SeedSequence([self.seed, dwell_no])
                   .generate_state(1, np.uint64)[0] >> 1)

    def _emit(self, n, k0_mod, k0_mod2, t_off, amp_db0, amp2_db0, noise_std):
        dev = self.device
        f32 = torch.float32
        fs = float(self.sample_rate_sps)
        fsc = self.full_scale
        period = float(self.scan_period_sec)
        k = k0_mod + torch.arange(n, dtype=torch.int64, device=dev)
        km = (k % self._pri_n).to(f32)
        if period > 0:
            dt = torch.arange(n, dtype=f32, device=dev) / float(np.float32(fs))
            d = torch.remainder(t_off + dt, period) - period / 2
            env = -float(self.scan_curvature_db_per_s2) * d * d
        else:
            env = torch.zeros(n, dtype=f32, device=dev)
        zero = torch.zeros((), dtype=f32, device=dev)
        amp = torch.where(km < self._pw_n,
                          torch.pow(10.0, (amp_db0 + env) / 20.0), zero)
        ph = float(np.float32(2.0 * np.pi * self.tone_offset_hz / fs)) * km
        sig_r = amp * torch.cos(ph)
        sig_i = amp * torch.sin(ph)
        if self.rel_amplitude2 > 0:
            k2 = k0_mod2 + torch.arange(n, dtype=torch.int64, device=dev)
            km2 = (k2 % self._pri2_n).to(f32)
            amp2 = torch.where(km2 < self._pw2_n,
                               torch.full((), 10.0 ** (amp2_db0 / 20.0),
                                          dtype=f32, device=dev), zero)
            ph2 = float(np.float32(2.0 * np.pi * self.tone2_offset_hz / fs)) * km2
            sig_r = sig_r + amp2 * torch.cos(ph2)
            sig_i = sig_i + amp2 * torch.sin(ph2)
        self._gen.manual_seed(self._dwell_seed(self._dwell_no))
        s = float(np.float32(noise_std) / np.float32(np.sqrt(2)))
        nr = torch.randn(n, generator=self._gen, device=dev, dtype=f32)
        ni = torch.randn(n, generator=self._gen, device=dev, dtype=f32)
        xr = torch.clamp(torch.round((sig_r + s * nr) * fsc), -fsc, fsc - 1)
        xi = torch.clamp(torch.round((sig_i + s * ni) * fsc), -fsc, fsc - 1)
        return xr * (1.0 / fsc), xi * (1.0 / fsc)

    def receive(self, num_samples: int, start_time: Optional[float] = None):
        fs = self.sample_rate_sps
        idx = self._abs_index
        if start_time is not None:
            want = int(round((start_time - self.start_epoch) * fs))
            if want > idx:
                self.counters.add("samples_skipped", want - idx)
            idx = max(idx, want)
        t0 = self.start_epoch + idx / fs
        db = self.gain_db - self.gain_ref_db
        amp_db0 = (20.0 * np.log10(self.rel_amplitude) + db
                   if self.rel_amplitude > 0 else -np.inf)
        amp2_db0 = (20.0 * np.log10(self.rel_amplitude2) + db
                    if self.rel_amplitude2 > 0 else -np.inf)
        noise_std = 10.0 ** ((self.noise_db + db) / 20.0)
        if self.scan_period_sec > 0:
            t_off = (t0 - self.scan_phase_sec + self.scan_period_sec / 2) \
                % self.scan_period_sec
        else:
            t_off = 0.0
        planes = self._emit(num_samples, idx % self._pri_n, idx % self._pri2_n,
                            float(np.float32(t_off)), float(amp_db0),
                            float(amp2_db0), noise_std)
        self._dwell_no += 1
        self._abs_index = idx + num_samples
        self.counters.add("dwells_received")
        self.counters.add("samples_received", num_samples)
        return planes, t0


@dataclasses.dataclass
class NativeEmulator:
    """Driver for the C++ ``sdr_record_emulator`` binary (``make -C
    native``).

    Runs the 7-positional-argument CLI (``blade_record_iq_12bit.cpp:33-48``
    contract) and returns the paths of the ``.iq`` dwell files it wrote.
    """

    binary: str = ""
    extra_args: Sequence[str] = ()

    def __post_init__(self):
        if not self.binary:
            repo = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            )
            self.binary = os.path.join(repo, "native", "build", "sdr_record_emulator")

    def available(self) -> bool:
        return os.path.exists(self.binary)

    def record(self, cfg: CaptureConfig, out_dir: str, **signal_kwargs) -> list:
        args = [
            self.binary,
            str(cfg.frequency_mhz),
            str(cfg.bandwidth_mhz),
            str(cfg.sample_rate_msps),
            str(cfg.rx_gain_db),
            str(cfg.dwell_sec),
            str(cfg.duration_sec),
            str(cfg.filter_delay_samples),
            "--out-dir", out_dir,
            "--bit-width", str(cfg.bit_width),
        ]
        for key, val in signal_kwargs.items():
            args += [f"--{key.replace('_', '-')}", str(val)]
        args += list(self.extra_args)
        before = set(os.listdir(out_dir))
        subprocess.run(args, check=True, capture_output=True)
        new = sorted(set(os.listdir(out_dir)) - before)
        return [os.path.join(out_dir, f) for f in new if f.endswith(".iq")]
