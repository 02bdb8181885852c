"""Streaming/blocking layer: run the channelize -> PDW chain over captures
too large for one device buffer, and over multi-file capture sets.

The reference's unit of storage is one ``.iq`` file per dwell with an
absolute ``sampleStartTime``, and its channelizer demo walks a capture in
windows.  This module formalizes both:

* :class:`CaptureSet` is an ordered set of ``.iq`` files grouped into
  *contiguous segments* (files whose start time continues the previous
  file's samples within half a sample period).  Timed dwells with gaps form
  separate segments, as the reference treats files independently while TOAs
  stay absolute.

* :class:`StreamingExtractor` is overlap-save block processing within a
  segment: the channelizer carries its FIR history from block to block and
  the PDW detector carries its latch state across blocks by composing
  transfer functions (``dsp.pdw.block_transfer``), with a look-ahead into
  the next block as the right halo, so that a pulse straddling a block
  boundary is emitted exactly once with exact statistics.  Block outputs
  concatenate bit for bit to the single-shot result.

``extract_segment_fused`` is the path for integer recordings: each block's
raw payload goes to the device as it is on disk and runs through the
hand-written kernels (``ops.cuda``: the channelizer's cm form, the
time-major latch, the pulse statistics with the saturation mask).
``extract_segment`` and ``extract`` are the oracle forms: the channelizer's
default form (the FFT on the CPU; on the card the channelizer kernel's
complex form, seeded with each block's history) and the plain PyTorch
block extractor; they also run wideband (``channelizer=None``).

Staged steps (the JAX package's ``jax.jit`` sites, ``_staging``): on the
card the fused block step (the packed channelization, the kernel tail and
the block's latch transfer), the floor pass's block channelization and the
oracle block step run as CUDA graphs captured once a key.  The exact floor
of ``extract_segment_fused`` is one launch of K2 (``ops.noise_floor``)
over the segment's channel-major magnitudes gathered on the device (a
launch a group of channels where the card's memory is short).  The
latch entry is chained on the device; a block's transfer comes to the host
only where a checkpoint is written.  ``plain=True`` runs every step
eagerly, and the floor as the JAX package's radix descent of count passes.

Spans (``utils.profiling``): ``entry.extract_segment[_fused]`` around a
segment, ``stream.read`` around each block's read from the files,
``stream.floor`` around the exact floor's measure (its reads, uploads and
steps are spans of their own), ``stream.to_host`` around each block's
batch brought to the host.

Noise floors: the reference uses the median over the *whole* capture, which
no single streaming pass can produce.  ``noise_floor="two_pass"`` (default)
measures exact floors in a pass of their own (on the card over the
magnitudes gathered on the device, else by streamed counting passes) and then
detects; ``"first_block"`` (``extract`` only) estimates from the first
block; or pass precomputed per-channel floors.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch._staging import Staged
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.dsp.channelizer import (
    Channelizer,
    ChannelizerState,
    _channelize_block,
)
from sdr_channelizer_tpu_torch.io import iqpacket
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops import medians
from sdr_channelizer_tpu_torch.utils import profiling
from sdr_channelizer_tpu_torch.utils.metrics import Counters

_FIELD_NAMES = ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db",
                "freq_offset_hz", "saturated", "valid", "count")


def _sortable_u32_np(x: np.ndarray) -> np.ndarray:
    """Order-preserving f32 -> u32 keys (NumPy twin of
    ``ops.medians.sortable_u32``; same total order, NaNs sort high)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    neg = (u >> np.uint32(31)) == 1
    return np.where(neg, ~u, u | np.uint32(0x80000000))


def _u32_to_f32_np(u: np.ndarray) -> np.ndarray:
    u = np.atleast_1d(np.ascontiguousarray(u, np.uint32))
    neg = (u >> np.uint32(31)) == 0
    raw = np.where(neg, ~u, u & np.uint32(0x7FFFFFFF))
    return raw.view(np.float32)


def _nf_count_le(mag: torch.Tensor, prefix: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """Per-channel ``count(key <= cut)`` for the 15 cut points of one 4-bit
    radix level.  ``mag`` is a device-resident (T, M) block (a view of a
    channel-major one), ``prefix`` the (M,) key prefixes found so far (int64
    holding u32), ``shift`` the level's bit shift as a 0-d int64 tensor;
    returns (M, 15) int64 counts."""
    keys = medians.sortable_u32(mag)  # (T, M)
    j = torch.arange(1, 16, dtype=torch.int64, device=mag.device)
    cuts = (prefix[:, None] | (j[None, :] << shift)) - 1
    return (keys[:, :, None] <= cuts[None, :, :]).sum(dim=0)


def _nf_finish(mag: torch.Tensor, prefix: torch.Tensor):
    """Per-channel ``(count(key <= prefix), least value above prefix)``: the
    pass that finds the upper middle without a second descent."""
    keys = medians.sortable_u32(mag)
    above = keys > prefix[None, :]
    inf = torch.full((), float("inf"), dtype=mag.dtype, device=mag.device)
    return (~above).sum(dim=0), torch.where(above, mag, inf).amin(dim=0)


@dataclasses.dataclass
class Segment:
    """A maximal run of time-contiguous dwell files."""

    paths: List[str]
    headers: List[iqpacket.IqHeader]

    @property
    def start_time(self) -> float:
        return self.headers[0].sample_start_time

    @property
    def num_samples(self) -> int:
        return sum(h.num_samples for h in self.headers)

    def iter_samples(self, block_samples: int) -> Iterator[np.ndarray]:
        """Yield normalized complex64 blocks of exactly ``block_samples``
        (the last block may be short)."""
        carry = np.zeros(0, np.complex64)
        for path, hdr in zip(self.paths, self.headers):
            _, samples = iqpacket.read_iq(path)
            iq = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
            buf = np.concatenate([carry, iq]) if carry.size else iq
            n_full = buf.size // block_samples
            for k in range(n_full):
                yield buf[k * block_samples: (k + 1) * block_samples]
            carry = buf[n_full * block_samples:]
        if carry.size:
            yield carry

    def _spans(self, start: int, count: int):
        """``(path, header, lo, hi)`` of the parts of the files that cover
        ``count`` samples from segment offset ``start`` (clipped at the
        segment's end)."""
        pos = 0
        remaining = count
        for path, hdr in zip(self.paths, self.headers):
            n = hdr.num_samples
            if remaining <= 0:
                break
            if pos + n > start:
                lo = max(start - pos, 0)
                hi = min(n, lo + remaining)
                yield path, hdr, lo, hi
                remaining -= hi - lo
            pos += n

    def read_samples(self, start: int, count: int) -> np.ndarray:
        """Random-access read of ``count`` normalized samples from segment
        offset ``start`` (clipped at the segment end; memory-mapped, so only
        the requested span touches disk)."""
        out = []
        for path, hdr, lo, hi in self._spans(start, count):
            _, samples = iqpacket.read_iq(path)  # mmap-backed
            out.append(iqpacket.to_complex(np.asarray(samples[lo:hi]),
                                           hdr.bit_width))
        if not out:
            return np.zeros(0, np.complex64)
        return out[0] if len(out) == 1 else np.concatenate(out)

    def read_samples_raw(self, start: int, count: int) -> np.ndarray:
        """Raw-payload twin of :meth:`read_samples`: the (count, 2)
        int8/int16 samples straight off the mmap, not normalized: the packed
        streaming path ships these bytes to the device untouched.  All files
        of a segment must share one payload dtype."""
        out = []
        dtype = None
        for path, _, lo, hi in self._spans(start, count):
            _, samples = iqpacket.read_iq(path)
            part = np.asarray(samples[lo:hi])
            if dtype is None:
                dtype = part.dtype
            elif part.dtype != dtype:
                raise ValueError(
                    f"mixed payload dtypes in segment: {dtype} vs "
                    f"{part.dtype} ({path})")
            out.append(part)
        if not out:
            return np.zeros((0, 2), np.int16)
        return out[0] if len(out) == 1 else np.concatenate(out)


@dataclasses.dataclass
class CaptureSet:
    """Ordered ``.iq`` files split into contiguous segments."""

    segments: List[Segment]

    @classmethod
    def from_paths(
        cls, paths: Sequence[str], tol_samples: float = 0.5
    ) -> "CaptureSet":
        entries = []
        for p in paths:
            hdr, _ = iqpacket.read_iq(p)
            entries.append((hdr.sample_start_time, str(p), hdr))
        entries.sort(key=lambda e: e[0])
        segs: List[Segment] = []
        for t0, path, hdr in entries:
            if segs:
                prev = segs[-1].headers[-1]
                expected_end = (prev.sample_start_time
                                + prev.num_samples / prev.sample_rate_sps)
                gap = abs(t0 - expected_end) * hdr.sample_rate_sps
                same_rate = hdr.sample_rate_sps == prev.sample_rate_sps
                # At absolute UTC epochs (about 1.7e9 s) one float64 ulp is
                # about 2.4e-7 s, 13 samples at 56 Msps, so a sub-sample
                # tolerance would split contiguous dwells on representation
                # error alone.  Guard by a few ulps of the timestamps.
                ulp_guard = 4.0 * np.spacing(max(abs(t0), abs(expected_end),
                                                 1.0))
                tol = max(tol_samples, ulp_guard * hdr.sample_rate_sps)
                if same_rate and gap <= tol:
                    segs[-1].paths.append(path)
                    segs[-1].headers.append(hdr)
                    continue
            segs.append(Segment(paths=[path], headers=[hdr]))
        return cls(segments=segs)

    @classmethod
    def from_dir(cls, directory: str, pattern: str = "*.iq") -> "CaptureSet":
        import glob

        return cls.from_paths(sorted(glob.glob(os.path.join(directory, pattern))))


def _packed_view(raw: np.ndarray) -> np.ndarray:
    """The (N, 2) integer payload as one plane of packed (I, Q) pairs."""
    raw = np.ascontiguousarray(raw)
    return raw.view(np.int32 if raw.dtype == np.int16 else np.int16).ravel()


@dataclasses.dataclass
class StreamingExtractor:
    """Blockwise channelize -> PDW over one contiguous sample stream.

    With ``channelizer=None`` the extractor runs **wideband** (full rate,
    ``create_pdws.m`` semantics): the stream is treated as one channel, no
    decimation, scalar whole-capture median noise floor.

    ``device`` is where every block runs: the CUDA device unless the caller
    asked for ``"cpu"``.  ``plain=True`` runs the kernels' plain PyTorch
    versions on the same device instead of the kernels, for checking one
    against the other; nothing takes that path by itself.
    """

    channelizer: Optional[Channelizer]
    pdw_cfg: PdwConfig
    block_frames: int = 65536
    halo_frames: Optional[int] = None  # default: pdw_cfg.max_pulse_samples
    counters: Counters = dataclasses.field(default_factory=Counters)
    device: Optional[Union[str, torch.device]] = None
    plain: bool = False

    # Device memory the exact floor leaves beside the magnitudes it holds
    # (bytes): the block steps' working sets and the allocator's slack.
    _NF_HEADROOM_BYTES = 1 << 30

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            # full-float32 products on the whole path
            torch.backends.cuda.matmul.allow_tf32 = False
        self._ops = kernels.PLAIN if self.plain else kernels.KERNELS
        # the JAX package's jax.jit sites (streaming.py:261 and the fused
        # block step; its count passes, :67 and :84, run eagerly on the plain
        # route only); ``_eager`` runs their eager forms instead
        self._eager = self.plain
        self._staged_fused_block = Staged(
            self._fused_block, self.device, ("own_len", "bit_width"))
        self._staged_floor_block = Staged(self._floor_block, self.device,
                                          ("bit_width",))
        self._staged_detect_block = Staged(self._detect_block, self.device,
                                           ("own_len",))
        self._halo = self.halo_frames or self.pdw_cfg.max_pulse_samples
        if self.block_frames < self._halo:
            # The look-ahead into the next block is the halo; shorter blocks
            # would silently cut it below the longest pulse and break the
            # stitching contract for pulses that straddle a boundary.
            warnings.warn(
                f"block_frames={self.block_frames} is shorter than the "
                f"detection halo ({self._halo} frames): pulses straddling "
                f"block boundaries may be dropped; increase block_frames or "
                f"reduce max_pulse_samples/halo_frames",
                stacklevel=2,
            )

    @classmethod
    def from_reference(
        cls,
        taps_rev: Optional[np.ndarray],
        pdw_cfg: dict,
        block_frames: int = 65536,
        halo_frames: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "StreamingExtractor":
        """Build the extractor from parameters handed over as plain values:
        the (P, M) frame-aligned polyphase taps as a NumPy array (``None``
        for wideband) and the ``PdwConfig`` fields as a dict
        (``dataclasses.asdict``)."""
        return cls(
            channelizer=(None if taps_rev is None
                         else Channelizer.from_taps(taps_rev)),
            pdw_cfg=PdwConfig(**pdw_cfg),
            block_frames=block_frames,
            halo_frames=halo_frames,
            device=device,
        )

    # ------------------------------------------------------------ internals

    def _num_bands(self) -> int:
        return 1 if self.channelizer is None else self.channelizer.num_bands

    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        with warnings.catch_warnings():
            # a block read from a memory map is read-only; it is never written
            warnings.simplefilter("ignore", UserWarning)
            return torch.as_tensor(x).to(self.device)

    def _step(self, name: str):
        """The staged step ``name`` (``"fused_block"``, ...), or its eager
        form where the extractor runs eagerly."""
        staged = getattr(self, f"_staged_{name}")
        return staged.fn if self._eager else staged

    def _detect_block(self, mag_e, ph_e, sat_e, nf, entry, *, own_len: int):
        """The oracle block step on (T, M) streams: the block's batch and
        its whole-block latch transfer over the owned samples."""
        cfg = self.pdw_cfg
        mag_cm = mag_e.T.contiguous()
        batch = pdwmod.extract_pdws_block_core(
            mag_cm, ph_e.T.contiguous(), sat_e.T.contiguous(), nf, entry,
            own_len=own_len, **pdwmod._core_kwargs(cfg))
        a, b = pdwmod.block_transfer(
            mag_cm[:, :own_len], nf[:, None], cfg.snr_threshold_db,
            cfg.trailing_threshold_db)
        return batch, a, b

    def _block_streams(self, hist, xq, bit_width: int):
        """The channelizer kernel's cm form on a packed block: ``(mag,
        mag_cm, dph_cm, sat_cm)``; ``hist`` the packed P-1 frames before
        it, or None at the capture's start (zeros, as the kernel's own)."""
        return self._ops.channelize_cm(
            xq, self.channelizer.taps_rev, bit_width=bit_width,
            sat_level=self.pdw_cfg.saturation_level, history=hist)

    def _floor_block(self, hist, xq, *, bit_width: int):
        """The floor pass's block: its channel-major (M, T) magnitude, the
        channelizer's ``mag_cm`` (the bits of the time-major ``mag``)."""
        return self._block_streams(hist, xq, bit_width)[1]

    def _fused_block(self, hist, xq, nf, entry, *, own_len: int,
                     bit_width: int):
        """The fused block step: the block's batch through the kernel tail
        and its whole-block latch transfer over the ``own_len`` owned
        frames."""
        cfg = self.pdw_cfg
        mag, mag_cm, dph_cm, sat_cm = self._block_streams(hist, xq, bit_width)
        batch = pdwmod._extract_channelized_pallas_stats(
            mag, None, None, cfg, nf, entry_active=entry, own_len=own_len,
            cm_streams=(mag_cm, dph_cm, sat_cm), ops=self._ops)
        # mag_cm holds the bits of mag, with time already last
        a, b = pdwmod.block_transfer(
            mag_cm[:, :own_len], nf[:, None], cfg.snr_threshold_db,
            cfg.trailing_threshold_db)
        return batch, a, b

    def _channelized_blocks(self, sample_blocks: Iterator[np.ndarray]):
        """Channelize a sample-block stream; yields (T_i, M) complex tensors
        whose concatenation equals the single-shot channelizer output.
        Wideband mode (no channelizer): identity, one column per stream."""
        if self.channelizer is None:
            for block in sample_blocks:
                if block.size:
                    yield self._on_device(block)[:, None]
            return
        m = self.channelizer.num_bands
        state = self.channelizer.init_state(self.device)
        carry = np.zeros(0, np.complex64)
        for block in sample_blocks:
            buf = np.concatenate([carry, block]) if carry.size else block
            n_frames = buf.size // m
            carry = buf[n_frames * m:]
            if n_frames == 0:
                continue
            y, state = self.channelizer.stream_block(
                self._on_device(buf[: n_frames * m]), state)
            yield y

    def _noise_floor_from_mag_blocks(self, make_mag_blocks) -> np.ndarray:
        """Exact per-channel median from an iterator factory of host (T, M)
        float32 magnitude blocks: the two counting passes of
        :meth:`measure_noise_floor`, whatever the blocks' source."""
        bins = 1 << 16
        hist_hi = None
        n_total = 0
        for mag in make_mag_blocks():
            keys = _sortable_u32_np(mag)  # (T, M)
            m = keys.shape[1]
            if hist_hi is None:
                hist_hi = np.zeros((m, bins), np.int64)
            flat = (keys >> np.uint32(16)).astype(np.int64) + np.arange(m) * bins
            hist_hi += np.bincount(flat.ravel(), minlength=m * bins).reshape(m, bins)
            n_total += keys.shape[0]
        if not n_total:
            raise ValueError("empty sample stream: no samples to measure")
        m = hist_hi.shape[0]

        ks = (max((n_total - 1) // 2, 0), n_total // 2)
        cum = np.cumsum(hist_hi, axis=1)
        need = {}
        locs = np.empty((m, 2), np.int64)
        below = np.empty((m, 2), np.int64)
        for c in range(m):
            for j, k in enumerate(ks):
                b = int(np.searchsorted(cum[c], k + 1, side="left"))
                locs[c, j] = b
                below[c, j] = int(cum[c, b - 1]) if b else 0
                need.setdefault((c, b), len(need))

        hist_lo = np.zeros((len(need), bins), np.int64)
        for mag in make_mag_blocks():
            keys = _sortable_u32_np(mag)
            for (c, b), row in need.items():
                col = keys[:, c]
                sel = col[(col >> np.uint32(16)) == b]
                if sel.size:
                    hist_lo[row] += np.bincount(
                        (sel & np.uint32(0xFFFF)).astype(np.int64),
                        minlength=bins)

        vals = np.empty((m, 2), np.float32)
        for c in range(m):
            for j in range(2):
                b = locs[c, j]
                cl = np.cumsum(hist_lo[need[(c, b)]])
                r = ks[j] - below[c, j]
                low = int(np.searchsorted(cl, r + 1, side="left"))
                vals[c, j] = _u32_to_f32_np(np.uint32((b << 16) | low))[0]
        return np.float32(0.5) * (vals[:, 0] + vals[:, 1])

    def _nf_budget_bytes(self, need: int) -> int:
        """Bytes of the device's memory the exact floor may hold, found out
        as far as ``need`` asks: the allocator's unused cache where that
        holds ``need`` (no ``mem_get_info`` query: from a stream's second
        segment on, the first one's floor left it there), else that and
        what the device has free, less ``_NF_HEADROOM_BYTES``; host memory
        for a CPU device."""
        if self.device.type != "cuda":
            free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            return free - self._NF_HEADROOM_BYTES
        stats = torch.cuda.memory_stats(self.device)
        cached = (stats.get("reserved_bytes.all.current", 0)
                  - stats.get("allocated_bytes.all.current", 0))
        if cached >= need:
            return cached
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + cached - self._NF_HEADROOM_BYTES

    def _noise_floor_device(self, make_mag_blocks_dev, m: int,
                            n_frames: int) -> np.ndarray:
        """Exact per-channel median of the stream's channel-major (M, t)
        magnitude blocks, ``n_frames`` in all, with the selection on the
        device.

        The kernel route (``self._ops is kernels.KERNELS``, the default)
        copies the blocks in time order into one (M, n_frames) buffer and
        runs K2 (``ops.noise_floor``) over it once; the (M,) floor is the
        one transfer to the host.  Where the buffer and K2's candidates (a
        quarter of it) exceed :meth:`_nf_budget_bytes`, the channels go in
        groups that fit, one pass over the blocks and one K2 launch a
        group.  Where not one channel fits, or a channel holds more frames
        than K2 takes (2^31), the floor is the descent below over blocks
        made anew for each of its passes.

        The plain route (``plain=True``) is the JAX package's: a 4-bit radix
        descent over the order-preserving keys of the blocks, held on the
        device where they fit the budget: 8 count levels and one finish
        pass, each fetching per-channel count vectors (int64 counts, so no
        2^24 bound; counter ``nf_device_count_d2h_bytes`` of the
        extractor's ``counters``).

        Both give the mean of the order statistics of rank
        ``(n_frames - 1) // 2`` and ``n_frames // 2``, NaNs sorting high, as
        the host-histogram form does; but at an even ``n_frames`` with a NaN
        above the lower middle the descent's finish pass (``amin``, as the
        JAX package's ``jnp.min``) reads NaN where the others read the upper
        middle.
        """
        if not n_frames:
            raise ValueError("empty sample stream: no samples to measure")
        if self._ops is kernels.PLAIN:
            need = 4 * m * n_frames
            return self._noise_floor_descent(
                make_mag_blocks_dev, m, n_frames,
                resident=need <= self._nf_budget_bytes(need))
        budget = self._nf_budget_bytes(5 * m * n_frames)
        rows = min(m, budget // (5 * n_frames)) if n_frames < 1 << 31 else 0
        if rows < 1:
            return self._noise_floor_descent(make_mag_blocks_dev, m,
                                             n_frames, resident=False)
        floors = []
        for c0 in range(0, m, rows):
            buf = torch.empty((min(rows, m - c0), n_frames),
                              dtype=torch.float32, device=self.device)
            f = 0
            for b in make_mag_blocks_dev():
                buf[:, f:f + b.shape[1]] = b[c0:c0 + buf.shape[0]]
                f += b.shape[1]
            if f != n_frames:
                raise ValueError(f"the blocks hold {f} frames, not "
                                 f"{n_frames}")
            floors.append(self._ops.noise_floor(buf, n_frames))
            del buf  # the next group reuses its memory
        return torch.cat(floors).cpu().numpy()

    def _noise_floor_descent(self, make_mag_blocks_dev, m: int,
                             n_frames: int, *, resident: bool) -> np.ndarray:
        """The radix descent of :meth:`_noise_floor_device`: eager count
        passes over the blocks' time-major views, the blocks made once and
        held on the device (``resident``) or made anew for each of the nine
        passes."""
        held = [b.T for b in make_mag_blocks_dev()] if resident else None

        def mag_blocks():
            return held if resident else (b.T for b in make_mag_blocks_dev())

        dev = self.device
        k_lo, k_hi = (n_frames - 1) // 2, n_frames // 2
        prefix = np.zeros(m, np.uint32)
        d2h = 0

        def pref_dev():
            return torch.as_tensor(prefix.astype(np.int64), device=dev)

        for level in range(8):
            shift = 28 - 4 * level
            pd = pref_dev()
            sd = torch.tensor(shift, dtype=torch.int64, device=dev)
            # sum every block's counts on the device, fetch once per level
            tot = sum(_nf_count_le(b, pd, sd)
                      for b in mag_blocks()).cpu().numpy()
            d2h += tot.nbytes
            nib = np.sum(tot <= k_lo, axis=1).astype(np.uint32)
            prefix |= nib << np.uint32(shift)
        lo = _u32_to_f32_np(prefix)

        pd = pref_dev()
        outs = [_nf_finish(b, pd) for b in mag_blocks()]
        cnt_le = sum(c for c, _ in outs).cpu().numpy()
        mins = torch.stack([mn for _, mn in outs]).amin(dim=0).cpu().numpy()
        d2h += cnt_le.nbytes + mins.nbytes
        hi = np.where(cnt_le > k_hi, lo, mins.astype(np.float32))
        self.counters.add("nf_device_count_d2h_bytes", d2h)
        return (np.float32(0.5) * (lo + hi.astype(np.float32))).astype(
            np.float32)

    # ---------------------------------------------------------- entry points

    def measure_noise_floor(self, make_sample_blocks) -> np.ndarray:
        """Exact per-channel median magnitude over the whole stream in
        O(block) memory (pass 1 of the exact two-pass mode).

        The median is not streaming-composable, and keeping every block's
        magnitudes would defeat streaming a capture too large for memory;
        the selection runs as two counting passes over the order-preserving
        u32 key space instead.  Pass A histograms the top 16 key bits per
        channel, which locates the bucket of 65,536 keys that holds each
        middle order statistic; pass B histograms the low 16 bits within
        those buckets only.  Identical order statistics and mean of the two
        middles as ``np.median``.

        ``make_sample_blocks``: zero-argument callable returning a fresh
        sample-block iterator (consumed twice).
        """
        def mag_blocks():
            for y in self._channelized_blocks(make_sample_blocks()):
                yield y.abs().cpu().numpy()

        return self._noise_floor_from_mag_blocks(mag_blocks)

    def extract(
        self,
        make_sample_blocks,  # () -> Iterator[np.ndarray]; a callable, so
        # that the two-pass mode can read the source again
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
        noise_floor: Union[str, np.ndarray] = "two_pass",
    ) -> dict:
        """Run the stream; returns the host PDW dict (absolute TOAs and
        frequencies)."""
        m = self._num_bands()
        cfg = self.pdw_cfg
        halo = self._halo
        dev = self.device

        if isinstance(noise_floor, str) and noise_floor == "two_pass":
            nf = self._on_device(self.measure_noise_floor(make_sample_blocks))
        elif isinstance(noise_floor, str) and noise_floor == "first_block":
            nf = None  # set from the first block below
        else:
            nf = self._on_device(np.asarray(noise_floor, np.float32))

        entry = torch.zeros((m,), dtype=torch.bool, device=dev)
        results = []
        offsets = []
        offset = 0
        pending = None  # previous block's (mag, ph, sat) awaiting its halo

        detect = self._step("detect_block")

        def flush(prev, halo_streams, own_len, entry):
            streams = [torch.cat([p, h], dim=0)
                       for p, h in zip(prev, halo_streams)]
            return detect(*streams, nf, entry, own_len=own_len)

        short_halo = False  # the last flush's halo was cut by a short block
        for y in self._channelized_blocks(make_sample_blocks()):
            self.counters.add("samples_ingested", y.shape[0] * m)
            self.counters.add("blocks_processed")
            mag, ph, sat = pdwmod._prep_streams(y, cfg.saturation_level)
            if nf is None:
                nf = medians.median(mag, dim=0)
            if pending is not None:
                if short_halo:
                    # The previous flush saw a halo shorter than the longest
                    # pulse and the short block was not the last one: a
                    # pulse straddling the whole short block may be dropped.
                    warnings.warn(
                        f"a sample block shorter than the detection halo "
                        f"({halo} frames) arrived mid-stream: pulses "
                        f"straddling it may be dropped; use blocks of at "
                        f"least halo length", stacklevel=2,
                    )
                h = min(halo, mag.shape[0])
                short_halo = h < halo
                batch, a, b = flush(
                    pending, (mag[:h], ph[:h], sat[:h]), pending[0].shape[0],
                    entry)
                entry = torch.where(entry, b, a)
                results.append(pdwmod.batch_to_host(batch))
                offsets.append(offset)
                offset += int(pending[0].shape[0])
            pending = (mag, ph, sat)

        if pending is not None:
            # Last block: a +inf halo says "the capture ends here" (open
            # pulses die).
            batch, _, _ = flush(pending, self._end_pad(pending),
                                pending[0].shape[0], entry)
            results.append(pdwmod.batch_to_host(batch))
            offsets.append(offset)

        return self._finalize(results, offsets, fs, fc, sample_start_time)

    @staticmethod
    def _end_pad(streams):
        """One halo row past the end of the capture: +inf magnitude, zero
        phase, not saturated."""
        mag, ph, sat = streams
        m = mag.shape[1]
        return (mag.new_full((1, m), float("inf")), ph.new_zeros((1, m)),
                sat.new_zeros((1, m)))

    def _block_plan(self, segment: Segment, checkpoint_dir: Optional[str]):
        m = self._num_bands()
        n_frames = segment.num_samples // m
        n_blocks = max((n_frames + self.block_frames - 1) // self.block_frames,
                       1)
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        return m, n_frames, n_blocks

    def _segment_noise_floor(self, noise_floor, checkpoint_dir,
                             measure) -> torch.Tensor:
        """The (M,) noise floor on the device: given, read from the
        checkpoint, or measured by ``measure()`` and checkpointed."""
        if not isinstance(noise_floor, str):
            return self._on_device(np.asarray(noise_floor, np.float32))
        if noise_floor != "two_pass":
            raise ValueError(f"unsupported noise_floor mode {noise_floor!r}")
        nf_path = (os.path.join(checkpoint_dir, "noise_floor.npz")
                   if checkpoint_dir else None)
        if nf_path and os.path.exists(nf_path):
            return self._on_device(np.load(nf_path)["nf"])
        with profiling.span("stream.floor"):
            nf = np.asarray(measure(), np.float32)
        if nf_path:
            np.savez(nf_path, nf=nf)
        return self._on_device(nf)

    def _run_blocks(self, segment, n_frames, n_blocks, checkpoint_dir,
                    process_block, fc):
        """The block loop both segment extractors share: resume a block
        from its checkpoint or run ``process_block(f0, t_k, h_k, entry)`` ->
        ``(batch, a, b)`` and checkpoint it, chaining the latch entry on the
        device.  The batch comes to the host once a block; ``a`` and ``b``
        only where a checkpoint is written."""
        m = self._num_bands()
        block = self.block_frames
        results, offsets = [], []
        entry = torch.zeros((m,), dtype=torch.bool, device=self.device)
        for k in range(n_blocks):
            f0 = k * block
            t_k = min(block, n_frames - f0)
            path = (os.path.join(checkpoint_dir, f"block_{k:06d}.npz")
                    if checkpoint_dir else None)
            self.counters.add("blocks_processed")
            self.counters.add("samples_ingested", t_k * m)
            if path and os.path.exists(path):
                z = np.load(path)
                batch = pdwmod.PdwBatch(**{n: z[n] for n in _FIELD_NAMES})
                a, b = self._on_device(z["a"]), self._on_device(z["b"])
                self.counters.add("blocks_resumed_from_checkpoint")
            else:
                h_k = min(self._halo, n_frames - f0 - t_k)
                batch, a, b = process_block(f0, t_k, h_k, entry)
                with profiling.span("stream.to_host"):
                    batch = pdwmod.batch_to_host(batch)
                if path:
                    np.savez(
                        path, a=a.cpu().numpy(), b=b.cpu().numpy(),
                        **{n: getattr(batch, n) for n in _FIELD_NAMES})
            entry = torch.where(entry, b, a)
            results.append(batch)
            offsets.append(f0)
        return self._finalize(results, offsets,
                              segment.headers[0].sample_rate_sps, fc,
                              segment.start_time)

    @profiling.spanned("entry.extract_segment")
    def extract_segment(
        self,
        segment: Segment,
        fc: float = 0.0,
        noise_floor: Union[str, np.ndarray] = "two_pass",
        checkpoint_dir: Optional[str] = None,
    ) -> dict:
        """Block-random-access extraction over a :class:`Segment`, with
        optional checkpoint/resume, in the oracle forms (the channelizer's
        default form and the plain PyTorch block extractor; wideband with
        ``channelizer=None``).

        Each block of ``block_frames`` frames is processed independently:
        its FIR history is read again from the raw samples (frames
        ``[F-(P-1), F)``), its right halo is channelized alongside it, and
        its latch entry state is the composition of all previous blocks'
        stored transfer functions.  So a killed job resumes at the first
        unprocessed block with nothing computed twice and bit-identical
        output.  Checkpoints are one ``.npz`` per block keyed by block index
        plus a ``noise_floor.npz``.
        """
        wideband = self.channelizer is None
        p = 1 if wideband else self.channelizer.taps_per_band
        cfg = self.pdw_cfg
        ck = checkpoint_dir
        m, n_frames, n_blocks = self._block_plan(segment, ck)
        block = self.block_frames

        nf = self._segment_noise_floor(
            noise_floor, ck, lambda: self.measure_noise_floor(
                lambda: segment.iter_samples(block * m)))
        detect = self._step("detect_block")

        def process_block(f0, t_k, h_k, entry):
            hist_frames = min(p - 1, f0)
            with profiling.span("stream.read"):
                raw = segment.read_samples(
                    (f0 - hist_frames) * m, (hist_frames + t_k + h_k) * m
                ).reshape(-1, m)
            y = self._on_device(raw)
            if not wideband:
                hist = torch.zeros((p, m), dtype=torch.complex64,
                                   device=self.device)
                if hist_frames:
                    hist[p - hist_frames:] = y[:hist_frames]
                y, _ = _channelize_block(
                    y[hist_frames:].reshape(-1), ChannelizerState(hist),
                    self.channelizer.taps_rev, m)
            streams = pdwmod._prep_streams(y, cfg.saturation_level)
            if h_k < 1:  # the capture ends at this block: +inf pad
                streams = [torch.cat([s, e], dim=0) for s, e in
                           zip(streams, self._end_pad(streams))]
            return detect(*streams, nf, entry, own_len=t_k)

        return self._run_blocks(segment, n_frames, n_blocks, ck,
                                process_block, fc)

    @profiling.spanned("entry.extract_segment_fused")
    def extract_segment_fused(
        self,
        segment: Segment,
        fc: float = 0.0,
        noise_floor: Union[str, np.ndarray] = "two_pass",
        checkpoint_dir: Optional[str] = None,
    ) -> dict:
        """Packed-ingest streaming extraction through the hand-written
        kernels: the path for integer captures past one device buffer.

        Same block, checkpoint and latch-chaining contract as
        :meth:`extract_segment`, but each block's raw int16/int8 payload goes
        to the device untouched and runs through the channelizer kernel's cm
        form (the FIR history is the packed tail of the frames before the
        block), the time-major latch kernel and the pulse-statistics kernel
        with the saturation mask.

        The output equals the single-shot fused extraction
        (``models.ChannelizerPipeline.extract_fused``) pulse for pulse for
        pulses within the halo contract (not the FFT oracle route: the kernel
        computes the DFT as products, which differs from the FFT in the last
        place).  Checkpoints are one ``.npz`` per block, in a directory of
        their own (those of :meth:`extract_segment` hold other values).

        On a CUDA device the two-pass noise floor gathers the blocks'
        channel-major magnitudes on the device and selects over them there
        (:meth:`_noise_floor_device`, in groups of channels where the card's
        memory is short); on the CPU it takes the host-histogram form.  Both
        are exact.
        """
        if self.channelizer is None:
            raise ValueError("extract_segment_fused requires a channelizer "
                             "(wideband streaming uses extract_segment)")
        bit_width = segment.headers[0].bit_width
        p = self.channelizer.taps_per_band
        block = self.block_frames
        ck = checkpoint_dir
        m, n_frames, n_blocks = self._block_plan(segment, ck)
        if block + self._halo >= 1 << 24:
            raise ValueError(
                f"block_frames+halo = {block + self._halo} must stay below "
                f"2^24 (edge counts are float32); reduce block_frames")
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 was switched on: the "
                "streamed path needs full-float32 products")

        # a staged step copies a host block straight into its buffer
        put = self._on_device if self._eager else np.asarray

        def read_block(f0, t_k, h_k):
            """(packed history or None, packed block), over frames
            [f0 - hist, f0 + t_k + h_k)."""
            hist_frames = min(p - 1, f0)
            with profiling.span("stream.read"):
                raw = segment.read_samples_raw(
                    (f0 - hist_frames) * m, (hist_frames + t_k + h_k) * m)
            hist = None
            if f0 > 0:
                head = raw[: hist_frames * m]
                if hist_frames < p - 1:
                    # a block that starts fewer than P-1 frames into the
                    # capture: zeros before the capture's first frame
                    pad = np.zeros(((p - 1 - hist_frames) * m, raw.shape[1]),
                                   raw.dtype)
                    head = np.concatenate([pad, head])
                hist = put(_packed_view(head))
            return hist, put(_packed_view(raw[hist_frames * m:]))

        floor_block = self._step("floor_block")
        fused_block = self._step("fused_block")

        def dev_mag_blocks():
            for k in range(n_blocks):
                f0 = k * block
                t_k = min(block, n_frames - f0)
                yield floor_block(*read_block(f0, t_k, 0),
                                  bit_width=bit_width)

        def measure():
            if self.device.type == "cuda":
                return self._noise_floor_device(dev_mag_blocks, m, n_frames)
            return self._noise_floor_from_mag_blocks(
                lambda: (b.cpu().numpy().T for b in dev_mag_blocks()))

        nf = self._segment_noise_floor(noise_floor, ck, measure)

        def process_block(f0, t_k, h_k, entry):
            return fused_block(*read_block(f0, t_k, h_k), nf, entry,
                               own_len=t_k, bit_width=bit_width)

        return self._run_blocks(segment, n_frames, n_blocks, ck,
                                process_block, fc)

    def _finalize(self, results, offsets, fs, fc, sample_start_time) -> dict:
        wideband = self.channelizer is None
        m = self._num_bands()
        fields = {}
        for name in _FIELD_NAMES:
            parts = []
            for batch, off in zip(results, offsets):
                v = getattr(batch, name)
                if name in ("toa_idx", "te_idx"):
                    v = np.where(batch.valid, v.astype(np.int64) + off, -1)
                parts.append(v)
            if name == "count":
                fields[name] = np.sum(parts, axis=0)
            else:
                fields[name] = np.concatenate(parts, axis=1)  # (M, total)
        merged = pdwmod.PdwBatch(**fields)
        self.counters.add("pulses_emitted", int(np.sum(fields["valid"])))
        return pdwmod.finalize_pdws(
            merged,
            fs=fs / m,
            fc=fc,
            sample_start_time=sample_start_time,
            bin_offsets_hz=(None if wideband
                            else self.channelizer.center_frequencies(fs)),
        )
