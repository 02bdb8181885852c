"""Closed-loop real-time event tracker: the rebuild of the reference's
``cpp/usrp_predict_event.cpp``.

Per dwell (``usrp_predict_event.cpp:208-389``):

* saturation check on the raw samples -> gain down 1 dB (``:210-218``);
* noise floor = **mean** magnitude (not the offline median), 20 dB
  threshold (``:288-291``); PDW extraction runs on the device through
  :func:`dsp.pdw._extract_event_core`, which reproduces the C++ loop's
  per-pulse statistics: **mean** amplitude over the pulse (``:312,
  :325-330``), so extraction has no per-pulse window and no selection;
* more than ``min_pulses_for_fit`` pulses -> quadratic least-squares fit of
  SNR vs TOA; the event is the parabola peak (``:28-52, :348-352``); the fit
  runs on the device (:func:`dsp.events.quadratic_peak_time_masked`), so the
  per-dwell packed fetch is the tracker's only host sync;
* more than ``min_events_for_pri`` events -> next event = last event +
  median of event diffs (``:354-373``);
* feedback: the next dwell is scheduled at ``next_event - dwell/2``
  (``:229-241``) so the beam peak lands mid-dwell.

The dwell's device work is staged (``_staging``, the JAX package's jitted
``_extract_planes``): captured once a dwell shape as a CUDA graph on the
card and replayed, the packed fetch the dwell's one sync.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch._staging import Staged
from sdr_channelizer_tpu_torch.capture.hardware import DwellError
from sdr_channelizer_tpu_torch.config import EventConfig, PdwConfig
from sdr_channelizer_tpu_torch.dsp import events as eventsmod
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.utils.metrics import Counters


@dataclasses.dataclass
class DwellReport:
    """What one tracker step observed and decided."""

    start_time: float
    num_pulses: int
    saturated: bool
    gain_db: float
    event_time: Optional[float]
    next_event_time: Optional[float]


@dataclasses.dataclass
class EventTracker:
    """Drives a receiver, extracts PDWs on the device, fits events,
    schedules.  ``device``: the CUDA device unless the caller asks for
    ``"cpu"``."""

    radio: object  # Receiver protocol: receive(n, start_time) + gain_db
    dwell_sec: float
    pdw_cfg: PdwConfig = dataclasses.field(default_factory=PdwConfig.event)
    event_cfg: EventConfig = dataclasses.field(default_factory=EventConfig)
    saturation_level: float = 0.9999  # usrp_predict_event.cpp:336
    events: List[float] = dataclasses.field(default_factory=list)
    next_event_time: Optional[float] = None
    # dwell/pulse/saturation counters in place of the reference's stdout
    # prints (usrp_predict_event.cpp:311)
    counters: Counters = dataclasses.field(default_factory=Counters)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._staged_dwell = Staged(
            _dwell_planes, self.device,
            ("fs", "saturation_level", "snr_threshold_db", "max_pulses"))

    def _dwell_args(self) -> dict:
        """What a dwell's device work reads besides the planes, each a
        static argument of the staged dwell: a change captures anew."""
        return dict(fs=float(self.radio.sample_rate_sps),
                    saturation_level=self.saturation_level,
                    snr_threshold_db=self.pdw_cfg.snr_threshold_db,
                    max_pulses=self.pdw_cfg.max_pulses)

    def extract_planes(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """One dwell's device work on two float32 planes, eager: the mean
        noise floor (:288-289), the event core, the quadratic SNR-vs-TOA
        fit (:28-52, :348-352), packed into one (3, max_pulses) float32
        tensor.  Row 0 starts ``[count, saturated, event_time_rel]``; rows
        1-2 are the pulses' TOA indices (-1 where invalid) and SNRs.
        :meth:`step` runs it staged."""
        return _dwell_planes(xr, xi, **self._dwell_args())

    def _device_dwell(self, xr, xi) -> torch.Tensor:
        """The dwell's device work as :meth:`step` runs it: staged."""
        return self._staged_dwell(xr, xi, **self._dwell_args())

    def step(self) -> DwellReport:
        fs = self.radio.sample_rate_sps
        dwell_n = int(round(self.dwell_sec * fs))
        start = None
        if self.next_event_time is not None:
            start = self.next_event_time - self.dwell_sec / 2  # :229-241
        try:
            iq, t0 = self.radio.receive(dwell_n, start_time=start)
        except DwellError as e:
            # The reference loop logs the error code, counts overruns and
            # keeps looping; only whole dwells are processed
            # (usrp_predict_event.cpp / usrp_record_iq_12bit.cpp:201-227,
            # drop-don't-corrupt).  Skip this dwell, keep the schedule.
            self.counters.add("dwells")
            self.counters.add(f"dwell_errors_{e.code}")
            return DwellReport(
                start_time=start if start is not None else float("nan"),
                num_pulses=0, saturated=False,
                gain_db=float(self.radio.gain_db),
                event_time=None, next_event_time=self.next_event_time,
            )

        if isinstance(iq, tuple):
            # device-resident planes (DeviceDwellEmitter): no host copy; the
            # packed fetch below is the dwell's only transfer
            xr, xi = iq
        else:
            # host planes, each copied once into the staged dwell's input
            iq = np.asarray(iq)
            xr, xi = (np.ascontiguousarray(v, np.float32)
                      for v in (iq.real, iq.imag))
        packed = self._device_dwell(xr, xi).cpu().numpy()  # the one sync
        n_pulses = int(packed[0, 0])
        sat = bool(packed[0, 1] > 0.5)
        self.counters.add("dwells")
        self.counters.add("samples_ingested", dwell_n)
        if sat:
            self.radio.gain_db -= 1.0  # :210-218
            self.counters.add("saturation_events")
            self.counters.add("gain_decrements_db")

        self.counters.add("pulses_emitted", n_pulses)
        event_t = None
        t_peak = float(packed[0, 2])  # fitted on the device
        if n_pulses > self.event_cfg.min_pulses_for_fit:  # :348
            if np.isfinite(t_peak):
                event_t = t0 + t_peak
                self.events.append(event_t)
                self.counters.add("events_fitted")

        if len(self.events) > self.event_cfg.min_events_for_pri:  # :354
            diffs = np.diff(np.asarray(self.events))
            self.next_event_time = float(self.events[-1] + np.median(diffs))

        return DwellReport(
            start_time=t0,
            num_pulses=n_pulses,
            saturated=sat,
            gain_db=float(self.radio.gain_db),
            event_time=event_t,
            next_event_time=self.next_event_time,
        )

    def run(self, num_dwells: int) -> List[DwellReport]:
        return [self.step() for _ in range(num_dwells)]


def _dwell_planes(xr, xi, *, fs: float, saturation_level: float,
                  snr_threshold_db: float, max_pulses: int) -> torch.Tensor:
    """:meth:`EventTracker.extract_planes` with what it reads from the
    tracker as arguments."""
    mag = torch.sqrt(xr * xr + xi * xi)
    sat_mask = (xr.abs() >= saturation_level) | (xi.abs() >= saturation_level)
    batch = pdwmod._extract_event_core(mag, sat_mask, mag.mean(),
                                       snr_threshold_db, max_pulses)
    toa_rel = (batch.toa_idx.to(torch.float32) + 1.0) / fs
    event_rel = eventsmod.quadratic_peak_time_masked(
        toa_rel, batch.snr_db, batch.valid)
    # Whole-dwell saturation trips the gain feedback; the C++ flag is set on
    # in-pulse samples only (:336-340), but a saturated sample is >= 0.9999
    # full scale and so inside a pulse for any plausible threshold: the same
    # decisions.
    head = torch.zeros(max_pulses, device=mag.device)
    head[:3] = torch.stack([batch.count.to(torch.float32),
                            sat_mask.any().to(torch.float32),
                            event_rel.to(torch.float32)])
    return torch.stack([
        head,
        torch.where(batch.valid, batch.toa_idx.to(torch.float32),
                    torch.full((), -1.0, device=mag.device)),
        batch.snr_db,
    ])
