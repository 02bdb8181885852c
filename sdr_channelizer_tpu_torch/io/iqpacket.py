"""IqPacket binary ``.iq`` codec — all three format versions, both endians.

The on-disk format is the central contract of the reference system: the C++
recorders write it (reference ``cpp/IqPacket.h:9-25``, writer at
``cpp/blade_record_iq_12bit.cpp:320-323``) and the MATLAB analysis reads it
(canonical parser at ``matlab/convert_my_iq_to_mat.m:40-98``).  This module
reproduces those semantics exactly:

* the leading 32-bit word doubles as endianness + version magic:
  ``0x00000000`` big-endian (assumed v2 — an acknowledged gap in the
  reference parser, ``convert_my_iq_to_mat.m:43-45``), ``0x01010101`` LE v1,
  ``0x02020202`` LE v2, ``0x03030303`` LE v3;
* v1 stores ``frequencyHz`` as u32 ("doesn't interpret frequencies above
  2^32 Hz", ``convert_my_iq_to_mat.m:64``) and has no ``spare0`` word
  (104-byte header); v2/v3 store u64 frequency + ``spare0`` (112 bytes);
* gain is u32 in v1/v2 and f32 in v3 (``convert_my_iq_to_mat.m:73-77``);
* payload is interleaved I,Q stored as int8 when ``0 < bitWidth <= 8`` and
  int16 when ``8 < bitWidth <= 16`` (``convert_my_iq_to_mat.m:92-98``);
* normalization to [-1, 1) divides by ``2^(bitWidth-1)``
  (``create_pdws.m:30-32``) — so bladeRF "12-bit" SC16_Q11 int16 payloads
  divide by 2048 (``blade_record_iq_12bit.cpp:214,261``).

This is the port's own pure-NumPy copy of the codec; it shares no code with
the JAX package and is held byte-for-byte against it by the tests.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io as _io
import os
import threading
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

from sdr_channelizer_tpu_torch.utils import profiling

IQ_FILE_FORMAT = 3  # current version, cpp/IqPacket.h:7

MAGIC_TO_FORMAT = {
    0x00000000: (2, ">"),  # big-endian, assumed latest-at-the-time v2
    0x01010101: (1, "<"),
    0x02020202: (2, "<"),
    0x03030303: (3, "<"),
}
FORMAT_TO_MAGIC = {1: 0x01010101, 2: 0x02020202, 3: 0x03030303}

HEADER_SIZE_V1 = 104
HEADER_SIZE_V2 = 112  # also v3; cpp/IqPacket.h is 112 bytes packed

_STR_FIELDS = ("board_name", "serial_number", "fpga_version", "fw_version")


@dataclasses.dataclass
class IqHeader:
    """Parsed IqPacket header (cpp/IqPacket.h:9-25 field order)."""

    frequency_hz: float
    bandwidth_hz: float
    sample_rate_sps: float
    rx_gain_db: float
    num_samples: int
    bit_width: int
    sample_start_time: float
    link_speed: int = 0
    spare0: int = 0
    board_name: str = ""
    serial_number: str = ""
    fpga_version: str = ""
    fw_version: str = ""
    file_format: int = IQ_FILE_FORMAT
    big_endian: bool = False

    @property
    def full_scale(self) -> float:
        """Payload normalization divisor 2^(bitWidth-1) (create_pdws.m:30)."""
        return float(2 ** (self.bit_width - 1))

    @property
    def payload_dtype(self) -> np.dtype:
        if 0 < self.bit_width <= 8:
            return np.dtype(np.int8)
        if 8 < self.bit_width <= 16:
            return np.dtype(np.int16)
        raise ValueError(f"Unsupported bit width {self.bit_width}")

    @property
    def duration_sec(self) -> float:
        return self.num_samples / self.sample_rate_sps


def _encode_str16(s: str) -> bytes:
    raw = s.encode("ascii", "replace")[:16]
    return raw + b"\x00" * (16 - len(raw))


def _decode_str16(raw: bytes) -> str:
    return raw.rstrip(b"\x00").decode("ascii", "replace")


def parse_header(buf: bytes) -> Tuple[IqHeader, int]:
    """Parse an IqPacket header from ``buf``.

    Returns (header, payload_offset).  Mirrors the versioned reads of
    ``convert_my_iq_to_mat.m:40-98``.
    """
    if len(buf) < HEADER_SIZE_V1:
        raise ValueError(f"File too short for IqPacket header ({len(buf)} bytes)")
    magic = int(np.frombuffer(buf[:4], dtype="<u4")[0])
    if magic not in MAGIC_TO_FORMAT:
        raise ValueError(f"Unsupported endianness magic 0x{magic:08X}")
    fmt, bo = MAGIC_TO_FORMAT[magic]

    off = 4

    def take(dt: str, n: int = 1):
        nonlocal off
        a = np.frombuffer(buf, dtype=bo + dt, count=n, offset=off)
        off += a.nbytes
        return a[0] if n == 1 else a

    link_speed = int(take("u4"))
    if fmt == 1:
        frequency_hz = float(take("u4"))
    else:
        frequency_hz = float(take("u8"))
    bandwidth_hz = float(take("u4"))
    sample_rate_sps = float(take("u4"))
    if fmt >= 3:
        rx_gain_db = float(take("f4"))
    else:
        rx_gain_db = float(take("u4"))
    num_samples = int(take("u4"))
    bit_width = int(take("u4"))
    spare0 = int(take("u4")) if fmt >= 2 else 0

    strs = [_decode_str16(buf[off + 16 * i : off + 16 * (i + 1)]) for i in range(4)]
    off += 64
    sample_start_time = float(np.frombuffer(buf, dtype=bo + "f8", count=1, offset=off)[0])
    off += 8

    hdr = IqHeader(
        frequency_hz=frequency_hz,
        bandwidth_hz=bandwidth_hz,
        sample_rate_sps=sample_rate_sps,
        rx_gain_db=rx_gain_db,
        num_samples=num_samples,
        bit_width=bit_width,
        sample_start_time=sample_start_time,
        link_speed=link_speed,
        spare0=spare0,
        board_name=strs[0],
        serial_number=strs[1],
        fpga_version=strs[2],
        fw_version=strs[3],
        file_format=fmt,
        big_endian=(bo == ">"),
    )
    return hdr, off


def encode_header(hdr: IqHeader) -> bytes:
    """Serialize a header in its ``file_format`` version."""
    fmt = hdr.file_format
    if fmt not in FORMAT_TO_MAGIC and not hdr.big_endian:
        raise ValueError(f"Unsupported file format {fmt}")
    bo = ">" if hdr.big_endian else "<"
    out = _io.BytesIO()

    def put(dt: str, v):
        out.write(np.asarray(v, dtype=bo + dt).tobytes())

    magic = 0x00000000 if hdr.big_endian else FORMAT_TO_MAGIC[fmt]
    # The magic word is byte-symmetric so endianness of the write is moot.
    out.write(np.asarray(magic, dtype="<u4").tobytes())
    put("u4", hdr.link_speed)
    if fmt == 1:
        put("u4", int(hdr.frequency_hz) & 0xFFFFFFFF)
    else:
        put("u8", int(hdr.frequency_hz))
    put("u4", int(hdr.bandwidth_hz))
    put("u4", int(hdr.sample_rate_sps))
    if fmt >= 3:
        put("f4", hdr.rx_gain_db)
    else:
        put("u4", int(hdr.rx_gain_db) & 0xFFFFFFFF)
    put("u4", hdr.num_samples)
    put("u4", hdr.bit_width)
    if fmt >= 2:
        put("u4", hdr.spare0)
    for f in _STR_FIELDS:
        out.write(_encode_str16(getattr(hdr, f)))
    put("f8", hdr.sample_start_time)
    return out.getvalue()


def read_iq(
    path: Union[str, os.PathLike, BinaryIO], mmap: bool = True
) -> Tuple[IqHeader, np.ndarray]:
    """Read an ``.iq`` file.

    Returns ``(header, samples)`` with ``samples`` of shape
    ``(num_samples, 2)`` (I, Q columns) in the payload integer dtype —
    zero-copy memory-mapped when ``mmap=True`` and the payload is
    native-endian.  Raises if the payload length disagrees with the header
    (the reference asserts the same, ``convert_my_iq_to_mat.m:102``).
    """
    if hasattr(path, "read"):
        buf = path.read()
        return _decode(buf)
    path = os.fspath(path)
    if mmap:
        data = np.memmap(path, dtype=np.uint8, mode="r")
        hdr, off = parse_header(bytes(data[:HEADER_SIZE_V2].tobytes()))
        dt = hdr.payload_dtype
        bo = ">" if hdr.big_endian else "<"
        nbytes = hdr.num_samples * 2 * dt.itemsize
        avail = data.size - off
        if avail < nbytes:
            raise ValueError(
                f"Payload truncated: header says {hdr.num_samples} samples "
                f"({nbytes} bytes), file has {avail}"
            )
        payload = data[off : off + nbytes].view(np.dtype(bo + dt.char))
        samples = payload.reshape(hdr.num_samples, 2)
        return hdr, samples
    with open(path, "rb") as f:
        return _decode(f.read())


def _decode(buf: bytes) -> Tuple[IqHeader, np.ndarray]:
    hdr, off = parse_header(buf)
    dt = hdr.payload_dtype
    bo = ">" if hdr.big_endian else "<"
    samples = np.frombuffer(
        buf, dtype=np.dtype(bo + dt.char), count=hdr.num_samples * 2, offset=off
    ).reshape(hdr.num_samples, 2)
    if samples.shape[0] != hdr.num_samples:
        raise ValueError("Payload length mismatch")
    return hdr, samples


def write_iq(path: Union[str, os.PathLike, BinaryIO], hdr: IqHeader, samples: np.ndarray) -> None:
    """Write an ``.iq`` file (header + interleaved I,Q payload).

    ``samples``: integer array of shape ``(N, 2)``; its dtype must match the
    header ``bit_width`` storage class.  ``hdr.num_samples`` is overwritten
    with N (the recorders set numSamples to the trimmed payload length,
    ``blade_record_iq_12bit.cpp:314``).
    """
    samples = np.asarray(samples)
    if samples.ndim != 2 or samples.shape[1] != 2:
        raise ValueError(f"samples must be (N, 2); got {samples.shape}")
    if samples.dtype != hdr.payload_dtype:
        raise ValueError(
            f"samples dtype {samples.dtype} != header payload dtype {hdr.payload_dtype}"
        )
    hdr = dataclasses.replace(hdr, num_samples=samples.shape[0])
    bo = ">" if hdr.big_endian else "<"
    payload = samples.astype(np.dtype(bo + samples.dtype.char), copy=False)
    blob = encode_header(hdr) + payload.tobytes()
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(os.fspath(path), "wb") as f:
            f.write(blob)


def utc_filename(epoch_sec: float) -> str:
    """UTC millisecond-precision capture filename.

    ``"%04d_%02d_%02d_%02d_%02d_%02d_%03d.iq"`` of the UTC decomposition of
    ``epoch_sec`` (``cpp/Helper.cpp:6-23``; ``FILENAME_LENGTH 80`` bound,
    ``Helper.h:7``).
    """
    import math
    import time as _time

    secs = math.floor(epoch_sec)
    millis = int((epoch_sec - secs) * 1e3)
    t = _time.gmtime(secs)
    return (
        f"{t.tm_year:04d}_{t.tm_mon:02d}_{t.tm_mday:02d}_"
        f"{t.tm_hour:02d}_{t.tm_min:02d}_{t.tm_sec:02d}_{millis:03d}.iq"
    )


# ``to_complex`` cuts an output of at least this many bytes into row chunks,
# one a worker of its thread pool; a smaller one is one pass on the caller's
# thread.  The pool has a worker a core the process may run on, at most
# ``TO_COMPLEX_MAX_WORKERS``.  On an 8-core host of an H100 (Sapphire Rapids)
# the pool lost at 4 MiB (0.93 against 0.49 ms), won from 8 MiB on (0.99
# against 1.48 ms; 31 against 67 ms at 128 MB, in memory or from a fresh
# map of a file) and gained nothing past six workers.
TO_COMPLEX_PARALLEL_MIN_BYTES = 8 << 20
TO_COMPLEX_MAX_WORKERS = 6

_pool = None
_pool_lock = threading.Lock()


def _to_complex_pool(
) -> Tuple[Optional[concurrent.futures.ThreadPoolExecutor], int]:
    """The thread pool of ``to_complex``'s chunks and its number of
    workers, made at first use; ``(None, 1)`` where the process may run on
    one core only."""
    global _pool
    with _pool_lock:
        if _pool is None:
            workers = min(TO_COMPLEX_MAX_WORKERS, len(os.sched_getaffinity(0)))
            pool = (concurrent.futures.ThreadPoolExecutor(
                workers, thread_name_prefix="to_complex")
                    if workers > 1 else None)
            _pool = (pool, workers)
        return _pool


def _forget_pool() -> None:
    """In a forked child: the parent's workers did not come along."""
    global _pool, _pool_lock
    _pool = None
    _pool_lock = threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def to_complex(samples: np.ndarray, bit_width: int, dtype=np.complex64) -> np.ndarray:
    """Normalize integer I/Q to complex in [-1, 1).

    Exactly ``iq / 2^(bitWidth-1)`` then ``I + jQ`` (``create_pdws.m:30-33``):
    each component rounded to float32 and scaled there, whatever ``dtype``.
    ``samples`` is any (N, 2) integer array (int8, int16 or int32, either
    byte order, any strides, a file's map), or float pairs as a ``.mat``
    may hold them; the result is a fresh 1-D array of ``dtype``.  The scaled pairs are written straight into the result,
    seen as (N, 2) reals, in one pass: from ``TO_COMPLEX_PARALLEL_MIN_BYTES``
    on cut into contiguous row chunks on a thread pool, each chunk's output
    pages first touched by the thread that writes them.  Counters:
    ``ingest.to_complex_bytes`` (the result's bytes, every call) and
    ``ingest.to_complex_parallel_bytes`` (those of them written by the pool).
    """
    scale = np.float32(1.0 / 2 ** (bit_width - 1))
    out = np.empty(samples.shape[0], dtype=dtype)
    profiling.count("ingest.to_complex_bytes", out.nbytes)
    if not (samples.ndim == 2 and samples.shape[1] == 2
            and samples.dtype.kind in "iuf" and out.dtype.kind == "c"):
        out.real = samples[:, 0].astype(np.float32) * scale
        out.imag = samples[:, 1].astype(np.float32) * scale
        return out
    pairs = out.view(out.real.dtype).reshape(-1, 2)

    def scaled(lo: int, hi: int) -> None:
        # the product in float32, as ``astype(np.float32) * scale``, then
        # widened exactly where the result is complex128
        np.multiply(samples[lo:hi], scale, out=pairs[lo:hi], dtype=np.float32)

    n = samples.shape[0]
    pool, k = ((None, 1) if out.nbytes < TO_COMPLEX_PARALLEL_MIN_BYTES
               else _to_complex_pool())
    if pool is None:
        scaled(0, n)
        return out
    edges = [n * i // k for i in range(k + 1)]
    for f in [pool.submit(scaled, lo, hi) for lo, hi in zip(edges, edges[1:])]:
        f.result()
    profiling.count("ingest.to_complex_parallel_bytes", out.nbytes)
    return out


def from_complex(iq: np.ndarray, bit_width: int) -> np.ndarray:
    """Quantize normalized complex I/Q back to the payload integer format.

    MATLAB ``int16(x * 2^(bw-1))`` semantics: round half away from zero and
    saturate at the integer range (``generate_training_iq.m:95-98``).
    """
    dt = np.int8 if bit_width <= 8 else np.int16
    scale = float(2 ** (bit_width - 1))
    info = np.iinfo(dt)
    # np.round is round-half-even; MATLAB int16() rounds half away from zero.
    def _round_away(x):
        return np.sign(x) * np.floor(np.abs(x) + 0.5)

    i = np.clip(_round_away(np.real(iq) * scale), info.min, info.max).astype(dt)
    q = np.clip(_round_away(np.imag(iq) * scale), info.min, info.max).astype(dt)
    return np.stack([i, q], axis=-1)
