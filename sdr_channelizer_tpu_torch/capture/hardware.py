"""Real-hardware receiver backends behind the framework's ``Receiver`` seam.

Everything above the capture layer (gain search, event tracker, recorder
CLI) talks to a radio through one small protocol:

    receive(num_samples, start_time=None) -> (complex64 iq in [-1, 1), t0)
    gain_db           (mutable float attribute)
    sample_rate_sps   (float attribute)

:class:`~sdr_channelizer_tpu_torch.capture.emulator.EmulatedRadio`
implements it in-process; this module implements it over the vendor drivers
the reference uses -- UHD (Ettus B200mini, ``usrp_record_iq_12bit.cpp``) and
libbladeRF (bladeRF 2.0 micro, ``blade_record_iq_12bit.cpp``) -- reproducing
each recorder's device setup sequence step for step.

The drivers are **import-guarded and injectable**: construct with
``driver=<module>`` (tests pass an API double asserting the call sequence,
built through :mod:`capture.vendor_api`'s declared surfaces; a radio host
passes nothing and the real ``uhd`` / ``bladerf`` Python bindings are
imported).  The radios are host code: the samples they return go to the
card through the same entry points as the emulator's.

FPGA provisioning (reference ``cpp/loadFpgaA5:1-3`` / ``loadFpgaA9:1-3``)
is :func:`provision_bladerf` + the ``provision`` CLI subcommand: the same
three ``bladeRF-cli`` invocations (bitstream load, firmware flash,
info/version check).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Protocol, Tuple, runtime_checkable

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


@dataclasses.dataclass
class UhdRadio:
    """B200mini receive path over UHD — ``usrp_record_iq_12bit.cpp:46-149``.

    Setup sequence (same order as the reference):

    1. ``multi_usrp::make`` (``:46``)
    2. metadata: board name, mboard serial, ``/mboards/0/fpga_version`` and
       ``fw_version`` from the property tree (``:50-70``)
    3. ``set_clock_source("internal")``; ``set_rx_subdev_spec("A:A")``
       (``:73-76``)
    4. ``set_time_now(host epoch)`` + 100 ms settle (``:82-86``)
    5. stream args ``("sc16", "sc12")`` for 12-bit wire format, or
       ``("sc8", "sc8")`` for the 8-bit recorder
       (``usrp_record_iq_08bit.cpp:91``); ``get_rx_stream`` (``:91-92``)
    6. ``set_rx_rate`` / ``set_rx_bandwidth`` / ``set_rx_agc(False)`` /
       ``set_rx_gain`` / ``set_rx_antenna("RX2")`` (``:96-119``)
    7. timed tune: ``set_command_time(now + 0.1 s)``, ``set_rx_freq``,
       sleep 110 ms for LO lock, ``clear_command_time`` (``:123-136``)

    ``receive()`` issues ``STREAM_MODE_NUM_SAMPS_AND_DONE`` scheduled 100 ms
    ahead (or at ``start_time``) and blocks on ``recv`` with a
    dwell + 0.5 s timeout (``:145-149, :188-194``); the returned ``t0`` is
    the device-accurate ``metadata.time_spec`` (``:196``).
    """

    frequency_hz: float
    sample_rate_sps: float
    bandwidth_hz: float
    gain_db: float
    bit_width: int = 12  # 12 -> ("sc16","sc12"); 8 -> ("sc8","sc8")
    device_args: str = ""
    clock_source: str = "internal"  # usrp_record_iq_12bit.cpp:16
    subdev: str = "A:A"  # :17
    antenna: str = "RX2"  # :19
    driver: Optional[object] = None  # injectable `uhd` module
    overruns: int = 0   # ERROR_CODE_OVERFLOW count, :210-212
    timeouts: int = 0   # ERROR_CODE_TIMEOUT count, :206-208

    def __post_init__(self):
        if self.driver is None:
            try:
                import uhd  # type: ignore
            except ImportError as e:  # pragma: no cover - no driver here
                raise ImportError(
                    "UhdRadio needs the `uhd` Python bindings (UHD >= 4.5, "
                    "CMakeLists.txt:37); on hosts without a USRP use "
                    "capture.emulator.EmulatedRadio"
                ) from e
            self.driver = uhd
        uhd = self.driver

        self.usrp = uhd.usrp.MultiUSRP(self.device_args)  # :46
        self.board_name = str(self.usrp.get_mboard_name())  # :50
        rx_info = self.usrp.get_usrp_rx_info()
        self.serial_number = str(rx_info.get("mboard_serial"))  # :57
        # Property-tree reads (:60-70).  The Python property-tree exposure
        # varies by UHD version (capture/vendor_api.py UHD_MULTI_USRP
        # "get_tree") — metadata only, so degrade to "unknown" rather than
        # refuse the radio.
        try:
            tree = self.usrp.get_tree()
            self.fpga_version = str(
                tree.access_str("/mboards/0/fpga_version").get())
            self.fw_version = str(
                tree.access_str("/mboards/0/fw_version").get())
        except AttributeError:
            self.fpga_version = self.fw_version = "unknown"

        self.usrp.set_clock_source(self.clock_source)  # :73
        self.usrp.set_rx_subdev_spec(uhd.usrp.SubdevSpec(self.subdev))  # :76
        self.usrp.set_time_now(uhd.types.TimeSpec(time.time()))  # :82-84
        time.sleep(0.1)  # :86

        host_fmt, wire_fmt = (
            ("sc16", "sc12") if self.bit_width >= 12 else ("sc8", "sc8")
        )  # :91 / usrp_record_iq_08bit.cpp:91
        stream_args = uhd.usrp.StreamArgs(host_fmt, wire_fmt)
        self.rx_stream = self.usrp.get_rx_stream(stream_args)  # :92

        self.usrp.set_rx_rate(self.sample_rate_sps)  # :96
        self.sample_rate_sps = float(self.usrp.get_rx_rate())
        self.usrp.set_rx_bandwidth(self.bandwidth_hz)  # :103
        self.bandwidth_hz = float(self.usrp.get_rx_bandwidth())
        self.usrp.set_rx_agc(False)  # :109
        self.usrp.set_rx_gain(self.gain_db)  # :115
        self._gain_db = float(self.usrp.get_rx_gain())
        self.usrp.set_rx_antenna(self.antenna)  # :119

        self.usrp.clear_command_time()  # :125
        self.usrp.set_command_time(
            self.usrp.get_time_now() + uhd.types.TimeSpec(0.1)
        )  # :127
        self.usrp.set_rx_freq(uhd.types.TuneRequest(self.frequency_hz))  # :131
        time.sleep(0.110)  # :133: ~10 ms after the retune, LO lock
        self.usrp.clear_command_time()  # :135
        self.frequency_hz = float(self.usrp.get_rx_freq())  # :138

    @property
    def gain_db(self) -> float:
        return self._gain_db

    @gain_db.setter
    def gain_db(self, value: float) -> None:
        # Dataclass __init__ assigns before __post_init__ creates the device.
        if not hasattr(self, "usrp"):
            self._gain_db = float(value)
            return
        self.usrp.set_rx_gain(float(value))  # gain feedback, tracker :219
        self._gain_db = float(self.usrp.get_rx_gain())

    def receive(
        self, num_samples: int, start_time: Optional[float] = None
    ) -> Tuple[np.ndarray, float]:
        uhd = self.driver
        cmd = uhd.types.StreamCMD(uhd.types.StreamMode.num_done)  # :145
        cmd.num_samps = int(num_samples)
        cmd.stream_now = False
        t = start_time if start_time is not None else time.time() + 0.1  # :188
        cmd.time_spec = uhd.types.TimeSpec(float(t))
        self.rx_stream.issue_stream_cmd(cmd)  # :191

        meta = uhd.types.RXMetadata()
        dwell = num_samples / self.sample_rate_sps
        buf = np.empty((1, num_samples), np.complex64)
        got = int(self.rx_stream.recv(buf, meta, timeout=dwell + 0.5))  # :194

        # Streaming error-code switch (usrp_record_iq_12bit.cpp:201-218):
        # the reference logs TIMEOUT, counts OVERFLOW, logs anything else,
        # and then writes the dwell only if it is whole (:220-227).  Here
        # the same classes surface as counters + a coded DwellError the
        # recorder/tracker loops drop-don't-corrupt on; an overflow whose
        # data still arrived whole is counted and returned, like the
        # reference's fall-through.
        ec = getattr(uhd.types, "RXMetadataErrorCode", None)
        code_none = getattr(ec, "none", 0) if ec is not None else 0
        code_timeout = getattr(ec, "timeout", 0x1) if ec is not None else 0x1
        code_overflow = getattr(ec, "overflow", 0x8) if ec is not None else 0x8
        err = meta.error_code
        if err == code_overflow and err != code_none:
            self.overruns += 1  # :210-212
            if got != num_samples:
                raise DwellError(
                    "overflow",
                    f"ERROR_CODE_OVERFLOW: {got}/{num_samples} samples "
                    f"(overruns={self.overruns})",
                )
        elif err == code_timeout and err != code_none:
            self.timeouts += 1  # :206-208
            raise DwellError(
                "timeout",
                f"ERROR_CODE_TIMEOUT: got timeout before all samples "
                f"received ({got}/{num_samples})",
            )
        elif err != code_none:
            detail = (str(meta.strerror()) if hasattr(meta, "strerror")
                      else str(err))
            raise DwellError("other", f"rx error: {detail}")  # :215-217
        elif got != num_samples:
            raise DwellError(
                "short", f"short dwell: {got}/{num_samples} samples"
            )
        return buf[0], float(meta.time_spec.get_real_secs())  # :196


# libbladeRF stream geometry (blade_record_iq_12bit.cpp:207-210)
_BLADE_NUM_BUFFERS = 4
_BLADE_BUFFER_SIZE = 1024 * 1024
_BLADE_NUM_TRANSFERS = 2
_BLADE_TIMEOUT_MS = 3500


@dataclasses.dataclass
class BladeRadio:
    """bladeRF 2.0 micro receive path — ``blade_record_iq_12bit.cpp:52-280``.

    Setup sequence (same order as the reference): open first device
    (``:52-54``), read link speed / serial / board / FPGA / FW metadata
    (``:62-99``), default feature (``:102``), set frequency / sample rate /
    bandwidth (``:118-160``), manual gain control + gain (``:164-190``),
    ``sync_config`` with SC16_Q11_META (or SC8_Q7_META for 8-bit), 4 buffers
    x 1 MiSamples, 2 transfers, 3.5 s timeout (``:207-214``), enable the RX
    module (``:227``).

    ``receive()`` is a blocking ``sync_rx`` with metadata; ``t0`` is derived
    from the *returned* dwell timestamp — not the previous dwell's (the
    reference computes it before ``sync_rx`` fills the metadata,
    ``blade_record_iq_12bit.cpp:289-298``, a known bug we do not replicate).
    Overruns are counted, and like the reference the dwell is reported
    rather than silently patched (drop-don't-corrupt).
    """

    frequency_hz: float
    sample_rate_sps: float
    bandwidth_hz: float
    gain_db: float
    bit_width: int = 12  # 12 -> SC16_Q11 (/2048); 8 -> SC8_Q7 (/128)
    driver: Optional[object] = None  # injectable `bladerf` module
    overruns: int = 0

    def __post_init__(self):
        if self.driver is None:
            try:
                import bladerf  # type: ignore
            except ImportError as e:  # pragma: no cover - no driver here
                raise ImportError(
                    "BladeRadio needs the `bladerf` Python bindings "
                    "(libbladeRF, CMakeLists.txt:24); on hosts without a "
                    "bladeRF use capture.emulator.EmulatedRadio"
                ) from e
            self.driver = bladerf
        brf = self.driver

        self.dev = brf.BladeRF()  # open first device, :52-54
        self.channel = brf.CHANNEL_RX(0)  # :29
        self.link_speed = str(self.dev.get_device_speed())  # :62-75
        self.serial_number = str(self.dev.get_serial())  # :79
        self.board_name = str(self.dev.get_board_name())  # :85
        self.fpga_version = str(self.dev.get_fpga_version())  # :91
        self.fw_version = str(self.dev.get_fw_version())  # :97

        ch = self.channel
        self.dev.set_frequency(ch, int(self.frequency_hz))  # :118
        self.frequency_hz = float(self.dev.get_frequency(ch))
        self.sample_rate_sps = float(
            self.dev.set_sample_rate(ch, int(self.sample_rate_sps))  # :135
        )
        self.bandwidth_hz = float(
            self.dev.set_bandwidth(ch, int(self.bandwidth_hz))  # :150
        )
        self.dev.set_gain_mode(ch, brf.GainMode.Manual)  # MGC, :164
        self.dev.set_gain(ch, int(round(self.gain_db)))  # :180
        self._gain_db = float(self.dev.get_gain(ch))

        # The stock cffi binding exposes no metadata structs — without them
        # there are no timed dwells, device timestamps, or overrun flags
        # (vendor_api.py "KNOWN BINDING GAP"); fall back to the non-META
        # formats + host-clock timestamps there.
        self._has_meta = hasattr(brf, "Metadata")
        if self._has_meta:
            fmt = (brf.Format.SC16_Q11_META if self.bit_width >= 12
                   else brf.Format.SC8_Q7_META)  # :214 / blade_record_iq_08bit.cpp:214
        else:
            fmt = (brf.Format.SC16_Q11 if self.bit_width >= 12
                   else brf.Format.SC8_Q7)
        self.dev.sync_config(
            layout=brf.ChannelLayout.RX_X1,
            fmt=fmt,
            num_buffers=_BLADE_NUM_BUFFERS,
            buffer_size=_BLADE_BUFFER_SIZE,
            num_transfers=_BLADE_NUM_TRANSFERS,
            stream_timeout=_BLADE_TIMEOUT_MS,
        )  # :207-214
        self.dev.enable_module(ch, True)  # :227
        self._epoch0 = time.time()
        self._t0_ticks = (float(self.dev.get_timestamp(brf.RX))  # :274
                          if self._has_meta else 0.0)

    @property
    def gain_db(self) -> float:
        return self._gain_db

    @gain_db.setter
    def gain_db(self, value: float) -> None:
        if not hasattr(self, "dev"):
            self._gain_db = float(value)
            return
        self.dev.set_gain(self.channel, int(round(value)))
        self._gain_db = float(self.dev.get_gain(self.channel))

    def receive(
        self, num_samples: int, start_time: Optional[float] = None
    ) -> Tuple[np.ndarray, float]:
        brf = self.driver
        scale = float(1 << 11) if self.bit_width >= 12 else float(1 << 7)  # :261
        raw = np.empty(2 * num_samples, np.int16 if self.bit_width >= 12 else np.int8)
        if not self._has_meta:
            # Stock-binding fallback (vendor_api.py "KNOWN BINDING GAP"):
            # untimed blocking RX, host-clock timestamps, no overrun flag.
            if start_time is not None:
                wait = start_time - time.time()
                if wait > 0:
                    time.sleep(wait)
            self.dev.sync_rx(raw, num_samples, _BLADE_TIMEOUT_MS + 1500)
            t0 = time.time() - num_samples / self.sample_rate_sps
            iq = (raw[0::2].astype(np.float32)
                  + 1j * raw[1::2].astype(np.float32))
            return (iq / scale).astype(np.complex64), t0
        meta = brf.Metadata()
        if start_time is None:
            meta.flags = brf.META_FLAG_RX_NOW  # :290
        else:
            # Timed dwell at a device timestamp (ticks from the epoch sync).
            meta.timestamp = int(
                self._t0_ticks + (start_time - self._epoch0) * self.sample_rate_sps
            )
        self.dev.sync_rx(raw, num_samples, meta, _BLADE_TIMEOUT_MS + 1500)  # :298
        if getattr(meta, "status", 0) & getattr(brf, "META_STATUS_OVERRUN", 0):
            self.overruns += 1  # :304-307
        iq = (raw[0::2].astype(np.float32) + 1j * raw[1::2].astype(np.float32))
        t0 = self._epoch0 + (float(meta.timestamp) - self._t0_ticks) / self.sample_rate_sps
        return (iq / scale).astype(np.complex64), t0


# ---------------------------------------------------------------------------
# FPGA provisioning (reference component #12: cpp/loadFpgaA5, loadFpgaA9)
# ---------------------------------------------------------------------------

_FPGA_IMAGES = {  # loadFpgaA5:1 / loadFpgaA9:1
    "A5": "hostedxA5_v0.15.3.rbf",
    "A9": "hostedxA9_v0.15.3.rbf",
}
_FW_IMAGE = "bladeRF_fw_v2.4.0.img"  # loadFpgaA5:2


def provision_bladerf_commands(
    board: str, workarea: str = "~/workarea"
) -> List[List[str]]:
    """The three ``bladeRF-cli`` invocations of ``loadFpgaA5``/``loadFpgaA9``:
    load the hosted FPGA bitstream, flash the firmware image, then print
    info + version.  ``board`` is "A5" or "A9"."""
    if board not in _FPGA_IMAGES:
        raise ValueError(f"unknown bladeRF variant {board!r}; expected A5 or A9")
    rbf = f"{workarea}/{_FPGA_IMAGES[board]}"
    img = f"{workarea}/{_FW_IMAGE}"
    return [
        ["bladeRF-cli", "-l", rbf],
        ["bladeRF-cli", "-f", img],
        ["bladeRF-cli", "-e", "info", "-e", "version"],
    ]


def provision_bladerf(board: str, workarea: str = "~/workarea", runner=None) -> int:
    """Run the provisioning sequence; returns the first nonzero exit code
    (0 on success).  ``runner`` (injectable for tests) defaults to
    ``subprocess.call``."""
    if runner is None:
        import subprocess

        runner = subprocess.call
    for cmd in provision_bladerf_commands(board, workarea):
        rc = int(runner(cmd))
        if rc != 0:
            return rc
    return 0
