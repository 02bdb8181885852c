"""ctypes bindings for the native IqPacket codec (``native/libiqpacket.so``).

The reference's codec is C++ (``cpp/IqPacket.h`` + the writer inline in each
recorder, e.g. ``blade_record_iq_12bit.cpp:320-323``); this module loads the
native twin built by ``make -C native`` (``native/build/libiqpacket.so``, or
the path in ``SDR_CHANNELIZER_NATIVE_LIB``) and exposes the API of the port's
pure-NumPy codec, :mod:`sdr_channelizer_tpu_torch.io.iqpacket`, on the same
:class:`~sdr_channelizer_tpu_torch.io.iqpacket.IqHeader`.  :func:`available`
is False when the library has not been built, and callers keep the NumPy
codec.  A host codec only: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from sdr_channelizer_tpu_torch.io import iqpacket

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATHS = (
    os.path.join(_REPO_ROOT, "native", "build", "libiqpacket.so"),
    os.environ.get("SDR_CHANNELIZER_NATIVE_LIB", ""),
)


class _IqHeaderC(ctypes.Structure):
    _pack_ = 1
    _fields_ = [
        ("file_format", ctypes.c_uint32),
        ("big_endian", ctypes.c_uint32),
        ("link_speed", ctypes.c_uint32),
        ("frequency_hz", ctypes.c_uint64),
        ("bandwidth_hz", ctypes.c_uint32),
        ("sample_rate_sps", ctypes.c_uint32),
        ("rx_gain_db", ctypes.c_float),
        ("num_samples", ctypes.c_uint32),
        ("bit_width", ctypes.c_uint32),
        ("spare0", ctypes.c_uint32),
        ("board_name", ctypes.c_char * 17),
        ("serial_number", ctypes.c_char * 17),
        ("fpga_version", ctypes.c_char * 17),
        ("fw_version", ctypes.c_char * 17),
        ("sample_start_time", ctypes.c_double),
    ]


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for path in _LIB_PATHS:
        if path and os.path.exists(path):
            lib = ctypes.CDLL(path)
            lib.iq_parse_header.restype = ctypes.c_int
            lib.iq_parse_header.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(_IqHeaderC)]
            lib.iq_write_file.restype = ctypes.c_int
            lib.iq_write_file.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_IqHeaderC), ctypes.c_void_p]
            lib.iq_read_file.restype = ctypes.c_longlong
            lib.iq_read_file.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_IqHeaderC), ctypes.c_void_p,
                ctypes.c_uint64]
            lib.iq_filename_utc.restype = ctypes.c_int
            lib.iq_filename_utc.argtypes = [
                ctypes.c_double, ctypes.c_char_p, ctypes.c_uint64]
            _lib = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _to_py_header(h: _IqHeaderC) -> iqpacket.IqHeader:
    return iqpacket.IqHeader(
        frequency_hz=float(h.frequency_hz),
        bandwidth_hz=float(h.bandwidth_hz),
        sample_rate_sps=float(h.sample_rate_sps),
        rx_gain_db=float(h.rx_gain_db),
        num_samples=int(h.num_samples),
        bit_width=int(h.bit_width),
        sample_start_time=float(h.sample_start_time),
        link_speed=int(h.link_speed),
        spare0=int(h.spare0),
        board_name=h.board_name.decode("ascii", "replace"),
        serial_number=h.serial_number.decode("ascii", "replace"),
        fpga_version=h.fpga_version.decode("ascii", "replace"),
        fw_version=h.fw_version.decode("ascii", "replace"),
        file_format=int(h.file_format),
        big_endian=bool(h.big_endian),
    )


def _to_c_header(hdr: iqpacket.IqHeader) -> _IqHeaderC:
    h = _IqHeaderC()
    h.file_format = hdr.file_format
    h.big_endian = 1 if hdr.big_endian else 0
    h.link_speed = hdr.link_speed
    h.frequency_hz = int(hdr.frequency_hz)
    h.bandwidth_hz = int(hdr.bandwidth_hz)
    h.sample_rate_sps = int(hdr.sample_rate_sps)
    h.rx_gain_db = hdr.rx_gain_db
    h.num_samples = hdr.num_samples
    h.bit_width = hdr.bit_width
    h.spare0 = hdr.spare0
    h.board_name = hdr.board_name.encode("ascii", "replace")[:16]
    h.serial_number = hdr.serial_number.encode("ascii", "replace")[:16]
    h.fpga_version = hdr.fpga_version.encode("ascii", "replace")[:16]
    h.fw_version = hdr.fw_version.encode("ascii", "replace")[:16]
    h.sample_start_time = hdr.sample_start_time
    return h


def parse_header(buf: bytes) -> Tuple[iqpacket.IqHeader, int]:
    lib = _load()
    h = _IqHeaderC()
    off = lib.iq_parse_header(buf, len(buf), ctypes.byref(h))
    if off < 0:
        raise ValueError(f"native iq_parse_header failed: {off}")
    return _to_py_header(h), off


def read_iq(path) -> Tuple[iqpacket.IqHeader, np.ndarray]:
    """Native full-file read; same contract as ``iqpacket.read_iq``."""
    lib = _load()
    size = os.path.getsize(path)
    h = _IqHeaderC()
    # Worst case payload: every remaining byte is int8 I/Q.
    max_samples = max((size - 104) // 2, 0)
    buf = np.empty(max(max_samples * 2, 1) * 2, dtype=np.int8)  # int16 worst case
    n = lib.iq_read_file(
        os.fspath(path).encode(), ctypes.byref(h),
        buf.ctypes.data_as(ctypes.c_void_p), max_samples,
    )
    if n < 0:
        raise ValueError(f"native iq_read_file failed: {n}")
    hdr = _to_py_header(h)
    dt = hdr.payload_dtype
    samples = buf[: n * 2 * dt.itemsize].view(dt).reshape(int(n), 2).copy()
    return hdr, samples


def write_iq(path, hdr: iqpacket.IqHeader, samples: np.ndarray) -> None:
    """Native file write; same contract as ``iqpacket.write_iq``."""
    lib = _load()
    samples = np.ascontiguousarray(samples)
    if samples.ndim != 2 or samples.shape[1] != 2:
        raise ValueError(f"samples must be (N, 2); got {samples.shape}")
    if samples.dtype != hdr.payload_dtype:
        raise ValueError(f"dtype {samples.dtype} != {hdr.payload_dtype}")
    h = _to_c_header(hdr)
    h.num_samples = samples.shape[0]
    rc = lib.iq_write_file(
        os.fspath(path).encode(), ctypes.byref(h),
        samples.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(f"native iq_write_file failed: {rc}")


def filename_utc(epoch_sec: float) -> str:
    """UTC millisecond capture filename (``Helper.cpp:6-23`` semantics)."""
    lib = _load()
    buf = ctypes.create_string_buffer(96)
    n = lib.iq_filename_utc(epoch_sec, buf, len(buf))
    if n < 0:
        raise ValueError("iq_filename_utc failed")
    return buf.value.decode()
