"""Capture tier: emulated radio front-end, auto-gain search, closed-loop
event tracker, the wrapper of the native recorder binary, the real-hardware
backends and the TX/RX loopback (``capture.txrx``).

The reference's capture tier is hardware-bound C++ (bladeRF/UHD recorders,
gain search, the real-time ``usrp_predict_event`` tracker).  Here the same
control loops run against an emulated receiver (host NumPy, a device-side
twin, or the native ``sdr_record_emulator`` binary for file-producing
captures), with the DSP on the card; the real-hardware backends
(``capture.hardware``: :class:`UhdRadio`, :class:`BladeRadio`) implement
the same :class:`~sdr_channelizer_tpu_torch.capture.hardware.Receiver`
protocol behind import-guarded vendor drivers.
"""

from sdr_channelizer_tpu_torch.capture.emulator import (  # noqa: F401
    DeviceDwellEmitter,
    EmulatedRadio,
    NativeEmulator,
)
from sdr_channelizer_tpu_torch.capture.gain_search import (  # noqa: F401
    dwell_is_saturated,
    find_max_unsaturated_gain,
)
from sdr_channelizer_tpu_torch.capture.hardware import (  # noqa: F401
    BladeRadio,
    DwellError,
    Receiver,
    UhdRadio,
    provision_bladerf,
)
from sdr_channelizer_tpu_torch.capture.tracker import (  # noqa: F401
    DwellReport,
    EventTracker,
)
