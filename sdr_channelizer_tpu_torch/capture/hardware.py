"""The receiver seam of the capture tier.

Everything above the capture layer (gain search, event tracker, recorder
CLI) talks to a radio through one small protocol:

    receive(num_samples, start_time=None) -> (complex64 iq in [-1, 1), t0)
    gain_db           (mutable float attribute)
    sample_rate_sps   (float attribute)

:class:`~sdr_channelizer_tpu_torch.capture.emulator.EmulatedRadio`
implements it in-process.  The vendor-driver backends (UHD, libbladeRF) and
FPGA provisioning are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class Receiver(Protocol):
    """The capture seam: what gain search / tracker / recorders consume."""

    sample_rate_sps: float
    gain_db: float

    def receive(
        self, num_samples: int, start_time: Optional[float] = None
    ) -> Tuple[np.ndarray, float]:
        """Return ``num_samples`` normalized complex64 samples and the
        absolute epoch time of the first sample.  ``start_time`` in the
        future schedules a timed dwell; ``None`` receives now."""
        ...


class DwellError(RuntimeError):
    """A dwell failed in a way the reference recorders survive: they log,
    count, and keep looping; only whole dwells are ever written
    (``usrp_record_iq_12bit.cpp:201-227``, the drop-don't-corrupt rule).
    ``code`` is the reference's switch label ("timeout", "overflow",
    "short", or "other") so loops can count per class."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
