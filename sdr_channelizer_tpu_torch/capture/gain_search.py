"""Max-unsaturated-gain search: a host control loop.

The algorithm of ``cpp/blade_find_max_unsaturated_gain.cpp:227-277`` /
``usrp_find_max_unsaturated_gain.cpp:120-152``: receive a dwell at the
current gain, scan for any sample at or above ``saturation_fraction`` of
full scale (0.98), decrement the gain by ``gain_step_db`` (1 dB) if so, and
repeat for the requested number of dwells.  Works against any object with
``receive(n) -> (iq, t0)`` and a mutable ``gain_db`` (the
:class:`~sdr_channelizer_tpu_torch.capture.hardware.Receiver` protocol).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sdr_channelizer_tpu_torch.capture.hardware import DwellError
from sdr_channelizer_tpu_torch.config import GainSearchConfig
from sdr_channelizer_tpu_torch.utils.metrics import Counters


def dwell_is_saturated(
    iq: np.ndarray, cfg: GainSearchConfig = GainSearchConfig(),
    full_scale: float = 1.0,
) -> bool:
    """Reference saturation test: any |I| or |Q| >= 0.98 * full scale
    (``blade_find_max_unsaturated_gain.cpp:266-274``)."""
    level = cfg.saturation_fraction * full_scale
    return bool(
        np.any(np.abs(iq.real) >= level) or np.any(np.abs(iq.imag) >= level)
    )


def find_max_unsaturated_gain(
    radio,
    dwell_samples: int,
    num_dwells: int,
    cfg: GainSearchConfig = GainSearchConfig(),
    counters: Optional[Counters] = None,
) -> Tuple[float, List[Tuple[float, bool]]]:
    """Run the closed-loop search; returns (final_gain_db, history).

    ``history`` is a list of (gain_db, saturated) per dwell.  The quantized
    receive path normalizes to [-1, 1), so full scale is 1.0.  ``counters``
    (optional) accumulates dwell/saturation counts, the structured form of
    ``blade_find_max_unsaturated_gain.cpp:270``'s prints.
    """
    history: List[Tuple[float, bool]] = []
    for _ in range(num_dwells):
        try:
            iq, _ = radio.receive(dwell_samples)
        except DwellError as e:
            # drop-don't-corrupt: count the errored dwell, keep the gain,
            # keep looping (the reference loops log and continue)
            if counters is not None:
                counters.add("dwells")
                counters.add(f"dwell_errors_{e.code}")
            continue
        sat = dwell_is_saturated(iq, cfg, full_scale=1.0)
        history.append((radio.gain_db, sat))
        if counters is not None:
            counters.add("dwells")
            counters.add("samples_received", dwell_samples)
        if sat:
            radio.gain_db -= cfg.gain_step_db
            if counters is not None:
                counters.add("saturation_events")
                counters.add("gain_decrements_db", cfg.gain_step_db)
    return radio.gain_db, history
