"""Sharded channelize -> PDW pipeline over a (time x chan) mesh.

The reference processes captures on one device (MATLAB loops,
``create_pdws_channelized.m:79-136``); this module spreads the same work
over a :class:`~sdr_channelizer_tpu_torch.parallel.mesh.Mesh` and gives the
same PDWs as the single-device pipeline.  Design:

* **Time sharding.**  The sample axis splits into contiguous blocks, one per
  mesh row.  The polyphase FIR needs the previous ``P-1`` frames of history
  (``create_pdws_channelized.m:31-33``): each shard sends its tail frames to
  its right neighbour (overlap-save), so the blocks' outputs join into
  exactly the unsharded channelizer output (zero initial state, as MATLAB's
  System object).

* **Channel sharding.**  Channel extraction is a DFT product ``u @ W``; each
  mesh column owns a column slice of ``W`` (its bands) and all the PDW work
  for them.  On the fused routes the slice goes into the channelizer kernel
  (``w_parts``), whose every band is the full matrix's band bit for bit.

* **Exact PDW stitching.**  The detector's hysteresis latch is a
  composition of per-sample boolean transfer functions
  (``dsp.pdw.hysteresis_fns``).  Each shard computes its block's transfer
  function, an all-gather along time and an exclusive prefix of
  ``compose_transfer`` in shard order give every block's entry state, and
  each shard runs its extraction from that state.  A pulse is emitted by the
  shard owning its leading edge; its trailing edge and statistics may reach
  into a right halo (the next shard's head).  The last shard's halo has
  +inf magnitude for the latch, so a pulse still active at capture end is
  never emitted, the reference rule.  Sharded PDWs are then the unsharded
  ones, bit for bit, as long as the halo is longer than the longest pulse.

* **Noise floor.**  The reference takes the median magnitude of each band
  over the whole capture (``create_pdws_channelized.m:73``), a global
  reduction: each mesh column gathers its shards' owned columns along time
  and takes the median once, with the noise floor kernel on the fused
  routes and ``ops.medians.median`` on the oracle routes.

Routes, as in the JAX package: ``step`` / ``extract`` (complex capture, the
FFT oracle) and ``step_planes`` / ``extract_planes`` (float planes, the DFT
as four real products) are plain PyTorch; ``step_packed`` / ``step_fused``
/ ``extract_fused`` run the kernels.  Their ``route="cm2"`` is the main
path's composition: the channelizer kernel's channel-major form on each
shard's block and the next shard's first ``halo`` raw frames, the cm2
extraction tail with the block contract.  ``route="cm"`` runs the flat form
(``w_parts`` too) and exchanges the three time-major streams' halo instead;
its tail is the kernel tail (``stats="pallas"``) or the oracle block core
(``"xla"``); ``"auto"`` picks the kernel tail for shards on a card.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import channelizer as chmod
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.dsp.pdw import PdwBatch
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.medians import median
from sdr_channelizer_tpu_torch.parallel.mesh import (
    Mesh,
    Shard,
    ShardedCapture,
    shard_capture,
)

ROUTES = ("auto", "cm2", "cm")


def _cap_halo(halo: int, t_loc: int, strict: bool = False) -> int:
    """Cap the stitching halo at the shard block length, loudly.

    The exact stitching needs the halo to exceed the longest pulse; when
    shard blocks are shorter than that, boundary-straddling pulses may be
    dropped relative to the single-device extractor: warn (or, with
    ``strict``, refuse) instead of shrinking silently.
    """
    if halo > t_loc:
        msg = (
            f"requested PDW stitching halo ({halo} frames) exceeds the "
            f"per-shard block length ({t_loc} frames)"
        )
        fix = (
            "use fewer/longer time shards, a smaller max_pulse_samples, "
            "or an explicit halo_frames"
        )
        if strict:
            raise ValueError(
                f"{msg}; pulses longer than the block could be dropped at "
                f"shard boundaries (halo_mode='strict') — {fix}"
            )
        warnings.warn(
            f"{msg}; capping to {t_loc}. Pulses longer than the block may "
            f"be dropped at shard boundaries — {fix}", stacklevel=3,
        )
        return t_loc
    return halo


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")


def _entries(mesh: Mesh, transfers: Dict[Shard, tuple]
             ) -> Dict[Shard, torch.Tensor]:
    """Each shard's latch entry state from the blocks' transfer functions:
    an all-gather along time, then an exclusive prefix of
    ``compose_transfer`` (not commutative) in shard order; shard 0 enters
    inactive."""
    ga = mesh.gather_time({s: f[0] for s, f in transfers.items()})
    gb = mesh.gather_time({s: f[1] for s, f in transfers.items()})
    out = {}
    for j in ga:
        acc, entry = None, []
        for a, b in zip(ga[j], gb[j]):
            entry.append(torch.zeros_like(a) if acc is None else acc[0])
            acc = (a, b) if acc is None else pdwmod.compose_transfer(acc,
                                                                     (a, b))
        for s in mesh.local_shards:
            if s[1] == j:
                out[s] = entry[s[0]].to(mesh.device(s))
    return out


def _stack_batches(mesh: Mesh, batches: Dict[Shard, PdwBatch]) -> PdwBatch:
    """This process's shard batches as one batch stacked over its time rows:
    ``(rows, M, max_pulses)`` (``count`` ``(rows, M)``), on its first
    shard's device."""
    lo, hi = mesh.local_rows
    home = mesh.home

    def field(name):
        rows = [torch.cat([getattr(batches[(i, j)], name).to(home)
                           for j in range(mesh.n_chan)])
                for i in range(lo, hi)]
        return torch.stack(rows)

    return PdwBatch(**{f.name: field(f.name)
                       for f in dataclasses.fields(PdwBatch)})


def _assemble(mesh: Mesh, parts: Dict[Shard, torch.Tensor]) -> torch.Tensor:
    """Time-major (t_loc, m_loc) shard parts joined into this process's
    (rows * t_loc, M) block, on its first shard's device."""
    lo, hi = mesh.local_rows
    return torch.cat([torch.cat([parts[(i, j)].to(mesh.home)
                                 for j in range(mesh.n_chan)], dim=1)
                      for i in range(lo, hi)])


def _per_shard(mesh: Mesh, per_column: Dict[int, torch.Tensor]):
    """A per-column value on each of this process's shards' devices."""
    return {s: per_column[s[1]].to(mesh.device(s)) for s in mesh.local_shards}


def _time_major_tail(mesh: Mesh, cfg: PdwConfig, streams, nf, t_loc: int,
                     halo: int, kernel: bool) -> Dict[Shard, PdwBatch]:
    """Per-shard extraction from time-major (t_loc, m_loc) detection streams
    ``(mag, phase_deg, sat)``: the three streams' right halo comes left (the
    last shard's magnitude is +inf there), the latch is chained across
    shards, and the tail is the kernel tail (``kernel``) or the oracle block
    core.  ``streams`` is emptied shard by shard as each is extracted."""
    heads = [mesh.send_left({s: v[k][:halo] for s, v in streams.items()})
             for k in range(3)]
    entry = _entries(mesh, {
        s: pdwmod.block_transfer(v[0].T, nf[s][:, None], cfg.snr_threshold_db,
                                 cfg.trailing_threshold_db)
        for s, v in streams.items()})
    out = {}
    for s in mesh.local_shards:
        mag, ph, sat = streams.pop(s)
        hm, hp, hs = (h[s] for h in heads)
        if hm is None:  # the last shard: past the capture's end
            hm = torch.full((halo, mag.shape[1]), float("inf"),
                            device=mag.device)
            hp = ph.new_zeros((halo, ph.shape[1]))
            hs = sat.new_zeros((halo, sat.shape[1]))
        mag_e = torch.cat([mag, hm])
        ph_e = torch.cat([ph, hp])
        sat_e = torch.cat([sat, hs]).to(torch.bool)
        if kernel:
            out[s] = pdwmod._extract_channelized_pallas_stats(
                mag_e, ph_e, sat_e, cfg, nf[s], entry_active=entry[s],
                own_len=t_loc)
        else:
            out[s] = pdwmod.extract_pdws_block_core(
                mag_e.T, ph_e.T, sat_e.T, nf[s], entry[s], own_len=t_loc,
                **pdwmod._core_kwargs(cfg))
    return out


@dataclasses.dataclass
class ShardedPipeline:
    """Channelize -> noise floor -> PDW step over a (time, chan) mesh.

    ``halo_frames`` (decimated frames read past each block's right edge)
    must exceed the longest pulse for exact boundary stitching; it defaults
    to ``pdw_cfg.max_pulse_samples`` and is capped at the block length
    (``halo_mode="warn"``) or refused when it does not fit
    (``halo_mode="strict"``: the exact stitching or an error, never a
    silent drop).

    A step takes the capture whole (a host array or a tensor; each process
    lays out its own shards) or as a
    :class:`~sdr_channelizer_tpu_torch.parallel.mesh.ShardedCapture`
    (``parallel.multihost``).  Its batch is stacked over this process's time
    rows, ``(rows, M, max_pulses)``: with one process every row, the JAX
    package's ``(n_time, M, max_pulses)``.
    """

    mesh: Mesh
    channelizer: chmod.Channelizer
    pdw_cfg: PdwConfig
    halo_frames: Optional[int] = None
    halo_mode: str = "warn"

    def __post_init__(self):
        if any(self.mesh.device(s).type == "cuda"
               for s in self.mesh.local_shards):
            # full-float32 products on the whole path
            torch.backends.cuda.matmul.allow_tf32 = False
        self._w = None

    @classmethod
    def from_reference(
        cls,
        taps_rev: np.ndarray,
        pdw_cfg: dict,
        mesh: Mesh,
        halo_frames: Optional[int] = None,
        halo_mode: str = "warn",
    ) -> "ShardedPipeline":
        """Build the pipeline from parameters handed over as plain values:
        the (P, M) frame-aligned polyphase taps as a NumPy array and the
        ``PdwConfig`` fields as a dict (``dataclasses.asdict``)."""
        return cls(mesh=mesh, channelizer=chmod.Channelizer.from_taps(taps_rev),
                   pdw_cfg=PdwConfig(**pdw_cfg), halo_frames=halo_frames,
                   halo_mode=halo_mode)

    @property
    def _strict_halo(self) -> bool:
        if self.halo_mode not in ("warn", "strict"):
            raise ValueError(f"unknown halo_mode {self.halo_mode!r}")
        return self.halo_mode == "strict"

    @property
    def n_time(self) -> int:
        return self.mesh.n_time

    @property
    def n_chan(self) -> int:
        return self.mesh.n_chan

    # ------------------------------------------------------------- layout

    def _geometry(self, n_samples: int, fused: bool) -> Tuple[int, int, int]:
        """``(t_loc, halo, m_loc)`` of a capture of ``n_samples``; refuses a
        layout the route cannot run."""
        m = self.channelizer.num_bands
        if m % self.n_chan:
            raise ValueError(f"num_bands {m} not divisible by chan mesh axis "
                             f"{self.n_chan}")
        if n_samples % (self.n_time * m):
            raise ValueError(
                f"capture length {n_samples} must divide into "
                f"{self.n_time} time shards of whole {m}-sample frames")
        t_loc = n_samples // (self.n_time * m)
        p = self.channelizer.taps_rev.shape[0]
        if fused and t_loc < p - 1:
            raise ValueError(
                f"fused sharded pipeline needs at least P-1 = {p - 1} frames "
                f"per shard for the FIR history handoff; got {t_loc} "
                f"({n_samples} samples over {self.n_time} shards of "
                f"{m}-sample frames) — use fewer time shards")
        halo = _cap_halo(self.halo_frames or self.pdw_cfg.max_pulse_samples,
                         t_loc, self._strict_halo)
        return t_loc, halo, m // self.n_chan

    def _fused2_ok(self, n_samples: int) -> bool:
        """True when the cm2 route applies: the bands divide over the chan
        axis, the capture into whole frames a shard, and a shard has the
        P-1 frames of FIR history its neighbour needs.  (The JAX package
        also asks 8-row band slices and a block that fits its statistics
        kernel's VMEM: conditions of the TPU's layout, with nothing to
        match here.)"""
        m = self.channelizer.num_bands
        if m % self.n_chan or n_samples % (self.n_time * m):
            return False
        t_loc = n_samples // (self.n_time * m)
        return t_loc >= self.channelizer.taps_rev.shape[0] - 1

    def _w_cols(self, j: int) -> np.ndarray:
        """Mesh column ``j``'s columns of the shift-folded DFT matrix, (M,
        m_loc) complex64 on the host."""
        m = self.channelizer.num_bands
        m_loc = m // self.n_chan
        if self._w is None:
            self._w = chmod.dft_matrix(m, shifted=True)
        return self._w[:, j * m_loc:(j + 1) * m_loc]

    def _w_slice(self, j: int):
        """Mesh column ``j``'s band slice ``(wr, wi)`` for the channelizer
        kernel; None with one mesh column (the full matrix)."""
        if self.n_chan == 1:
            return None
        w = self._w_cols(j)
        return (np.ascontiguousarray(w.real, np.float32),
                np.ascontiguousarray(w.imag, np.float32))

    def _capture(self, x) -> ShardedCapture:
        return shard_capture(self.mesh, x)

    def _frames(self, caps: List[ShardedCapture], t_loc: int, dtype=None):
        """Each local shard's planes as (t_loc, M) frames."""
        m = self.channelizer.num_bands
        return {s: [c.parts[s].reshape(t_loc, m) if dtype is None
                    else c.parts[s].to(dtype).reshape(t_loc, m)
                    for c in caps]
                for s in self.mesh.local_shards}

    def _history(self, frames, t_loc: int):
        """Each shard's FIR history: its left neighbour's last P-1 frames of
        each plane (None for row 0, the zero initial state)."""
        p = self.channelizer.taps_rev.shape[0]
        n_planes = len(next(iter(frames.values())))
        if p == 1:
            return {s: [None] * n_planes for s in frames}
        sent = [self.mesh.send_right({s: f[k][t_loc - (p - 1):]
                                      for s, f in frames.items()})
                for k in range(n_planes)]
        return {s: [h[s] for h in sent] for s in frames}

    # --------------------------------------------------------- the oracle

    def _channelize_oracle(self, frames, t_loc: int, planes: bool):
        """Each shard's bands: the branch FIR with its history, then the FFT
        (one mesh column, complex) or the product with its DFT slice."""
        m = self.channelizer.num_bands
        hist = self._history(frames, t_loc)
        out = {}
        for s, fs_ in frames.items():
            dev = self.mesh.device(s)
            taps = torch.as_tensor(self.channelizer.taps_rev, device=dev)
            us = [chmod.fir_branches(f, taps, h)
                  for f, h in zip(fs_, hist[s])]
            w = self._w_cols(s[1])
            if planes:
                wr, wi = (torch.as_tensor(np.ascontiguousarray(v), device=dev)
                          for v in (w.real, w.imag))
                ur, ui = us
                out[s] = (ur @ wr - ui @ wi, ur @ wi + ui @ wr)
            elif self.n_chan == 1:
                out[s] = chmod._bands(us[0], m, True, "fft")
            else:
                out[s] = us[0] @ torch.as_tensor(np.ascontiguousarray(w),
                                                 device=dev)
        return out

    def _floor_median(self, mags) -> Tuple[dict, torch.Tensor]:
        """The oracle floor: each column's owned (t_loc, m_loc) magnitudes
        gathered along time, the median over time."""
        nf = {j: median(torch.cat(parts), dim=0)
              for j, parts in self.mesh.gather_time(mags).items()}
        return nf, torch.cat([nf[j].to(self.mesh.home) for j in sorted(nf)])

    def step(self, x):
        """The oracle step on a complex capture.  Returns ``(chan_iq
        (rows * t_loc, M), noise_floor (M,), batch)``."""
        cap = self._capture(x)
        t_loc, halo, _ = self._geometry(cap.n_samples, fused=False)
        frames = self._frames([cap], t_loc, torch.complex64)
        y = self._channelize_oracle(frames, t_loc, planes=False)
        nf_col, nf = self._floor_median({s: v.abs() for s, v in y.items()})
        nf_s = _per_shard(self.mesh, nf_col)
        streams = {s: pdwmod._prep_streams(v, self.pdw_cfg.saturation_level)
                   for s, v in y.items()}
        batches = _time_major_tail(self.mesh, self.pdw_cfg, streams, nf_s,
                                   t_loc, halo, kernel=False)
        return _assemble(self.mesh, y), nf, _stack_batches(self.mesh, batches)

    def step_planes(self, xr, xi):
        """The complex-free oracle step on float32 sample planes.  Returns
        ``(yr, yi, noise_floor, batch)``."""
        caps = [self._capture(xr), self._capture(xi)]
        t_loc, halo, _ = self._geometry(caps[0].n_samples, fused=False)
        frames = self._frames(caps, t_loc, torch.float32)
        y = self._channelize_oracle(frames, t_loc, planes=True)
        streams = {s: pdwmod._prep_streams_planes(
            yr, yi, self.pdw_cfg.saturation_level) for s, (yr, yi) in y.items()}
        nf_col, nf = self._floor_median({s: v[0] for s, v in streams.items()})
        nf_s = _per_shard(self.mesh, nf_col)
        batches = _time_major_tail(self.mesh, self.pdw_cfg, streams, nf_s,
                                   t_loc, halo, kernel=False)
        yr = _assemble(self.mesh, {s: v[0] for s, v in y.items()})
        yi = _assemble(self.mesh, {s: v[1] for s, v in y.items()})
        return yr, yi, nf, _stack_batches(self.mesh, batches)

    # ------------------------------------------------------- fused routes

    def _floor_kernel(self, owned) -> Tuple[dict, torch.Tensor]:
        """The noise floor kernel on each column's owned channel-major
        (m_loc, t_loc) columns, gathered along time into one (m_loc, T)
        buffer (the grid has no pad columns to mask)."""
        nf = {}
        for j, parts in self.mesh.gather_time(owned).items():
            buf = torch.cat(parts, dim=1)
            nf[j] = pdwmod.noise_floor_cm(buf, buf.shape[0], buf.shape[1])
        return nf, torch.cat([nf[j].to(self.mesh.home) for j in sorted(nf)])

    def _step_cm2(self, caps: List[ShardedCapture], bit_width: int):
        """The cm2 composition: each shard's raw (P-1)-frame tail goes right
        as FIR history and the next shard's first ``halo`` raw frames come
        left; the channelizer kernel's channel-major form runs on ``t_loc +
        halo`` frames with its band slice (the last shard's head is zeros),
        the floor is taken on the owned columns, the latch is chained, and
        the cm2 tail extracts with the block contract (latch magnitude +inf
        past the capture's end on the last shard).  The saturation count is
        per shard: the tail only ever differences it."""
        cfg, mesh = self.pdw_cfg, self.mesh
        t_loc, halo, m_loc = self._geometry(caps[0].n_samples, fused=True)
        taps = self.channelizer.taps_rev
        frames = self._frames(caps, t_loc)
        hist = self._history(frames, t_loc)
        heads = [mesh.send_left({s: f[k][:halo] for s, f in frames.items()})
                 for k in range(len(caps))]
        streams = {}
        for s, fs_ in frames.items():
            ext = [torch.cat([f, f.new_zeros((halo, f.shape[1]))
                              if h[s] is None else h[s]]).reshape(-1)
                   for f, h in zip(fs_, heads)]
            hs = [None if h is None else h.reshape(-1) for h in hist[s]]
            kw = dict(bit_width=bit_width, sat_level=cfg.saturation_level,
                      w_parts=self._w_slice(s[1]))
            if len(caps) == 1:
                streams[s] = kernels.KERNELS.channelize(
                    ext[0], taps, history=hs[0], **kw)
            else:
                streams[s] = kernels.KERNELS.channelize_planes(
                    ext[0], ext[1], taps,
                    history=None if hs[0] is None else tuple(hs), **kw)
        del frames, heads, hist
        nf_col, nf = self._floor_kernel(
            {s: v[0][:, :t_loc] for s, v in streams.items()})
        nf_s = _per_shard(mesh, nf_col)
        entry = _entries(mesh, {
            s: pdwmod.block_transfer(v[0][:, :t_loc], nf_s[s][:, None],
                                     cfg.snr_threshold_db,
                                     cfg.trailing_threshold_db)
            for s, v in streams.items()})
        batches = {}
        for s in mesh.local_shards:
            mag_cm, dph_cm, satcs_cm = streams.pop(s)
            latch = mag_cm
            if s[0] == self.n_time - 1:
                latch = mag_cm.clone()
                latch[:, t_loc:] = float("inf")
            batches[s] = pdwmod._extract_channelized_cm2(
                mag_cm, dph_cm, satcs_cm, cfg, nf_s[s], t_loc + halo, m_loc,
                entry_active=entry[s], own_len=t_loc, mag_latch_cm=latch)
        return nf, _stack_batches(mesh, batches)

    def _step_cm(self, caps: List[ShardedCapture], bit_width: int,
                 stats: str):
        """Route cm: the channelizer kernel's flat form on each shard's
        block with its FIR history and band slice, the floor on the owned
        magnitudes, then the time-major tail with the three streams' halo."""
        cfg, mesh = self.pdw_cfg, self.mesh
        t_loc, halo, _ = self._geometry(caps[0].n_samples, fused=True)
        kernel = pdwmod._kernel_tail(stats, next(iter(caps[0].parts.values())))
        taps = self.channelizer.taps_rev
        frames = self._frames(caps, t_loc)
        hist = self._history(frames, t_loc)
        streams = {}
        for s, fs_ in frames.items():
            kw = dict(bit_width=bit_width, sat_level=cfg.saturation_level,
                      w_parts=self._w_slice(s[1]))
            hs = hist[s]
            if len(caps) == 1:
                streams[s] = kernels.KERNELS.channelize_flat(
                    fs_[0].reshape(-1), taps,
                    history=None if hs[0] is None else hs[0].reshape(-1),
                    **kw)
            else:
                streams[s] = kernels.KERNELS.channelize_flat_planes(
                    fs_[0].reshape(-1), fs_[1].reshape(-1), taps,
                    history=None if hs[0] is None else tuple(
                        h.reshape(-1) for h in hs), **kw)
        del frames, hist
        nf_col, nf = self._floor_kernel(
            {s: v[0].T.contiguous() for s, v in streams.items()})
        batches = _time_major_tail(mesh, cfg, streams,
                                   _per_shard(mesh, nf_col), t_loc, halo,
                                   kernel)
        return nf, _stack_batches(mesh, batches)

    def _route(self, n_samples: int, stats: str, route: str) -> str:
        _check_route(route)
        if route == "auto":
            # an explicit stats mode pins route cm (the knob exists there
            # only); otherwise the cm2 composition
            return ("cm2" if stats == "auto" and self._fused2_ok(n_samples)
                    else "cm")
        return route

    def step_fused(self, xr, xi, bit_width: int = 0, stats: str = "auto",
                   route: str = "auto"):
        """The fused sharded step on two sample planes (int16 with
        ``bit_width``, or float32 with ``bit_width=0``).  Returns
        ``(noise_floor (M,), batch)``.  ``route``: ``"auto"`` takes
        ``"cm2"`` where :meth:`_fused2_ok`, else ``"cm"``."""
        caps = [self._capture(xr), self._capture(xi)]
        if self._route(caps[0].n_samples, stats, route) == "cm2":
            return self._step_cm2(caps, bit_width)
        return self._step_cm(caps, bit_width, stats)

    def step_packed(self, xq, bit_width: int = 12, stats: str = "auto",
                    route: str = "auto"):
        """The fused sharded step on the packed recorder payload (the (N, 2)
        int16 buffer viewed as int32, or int8 viewed as int16).  Returns
        ``(noise_floor (M,), batch)``; ``route`` as in :meth:`step_fused`."""
        cap = self._capture(xq)
        if self._route(cap.n_samples, stats, route) == "cm2":
            return self._step_cm2([cap], bit_width)
        return self._step_cm([cap], bit_width, stats)

    # ---------------------------------------------------------- host side

    def extract_fused(
        self,
        samples: np.ndarray,
        bit_width: int,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
        stats: str = "auto",
    ) -> dict:
        """Raw (N, 2) payload -> host PDW dict through the fused sharded
        step (the multi-device twin of
        ``models.ChannelizerPipeline.extract_fused``)."""
        samples = np.ascontiguousarray(samples)
        if samples.dtype in (np.int16, np.int8):
            wide = np.int32 if samples.dtype == np.int16 else np.int16
            _, batch = self.step_packed(samples.view(wide).ravel(),
                                        bit_width=bit_width, stats=stats)
        else:
            xr = np.ascontiguousarray(samples[:, 0], np.float32)
            xi = np.ascontiguousarray(samples[:, 1], np.float32)
            _, batch = self.step_fused(xr, xi, bit_width=bit_width,
                                       stats=stats)
        t_loc = samples.shape[0] // (self.n_time * self.channelizer.num_bands)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)

    def extract_planes(self, iq: np.ndarray, fs: float, fc: float = 0.0,
                       sample_start_time: float = 0.0) -> dict:
        """Host complex capture -> host PDW dict through the complex-free
        step (planes split on the host)."""
        iq = np.asarray(iq)
        xr = np.ascontiguousarray(iq.real, np.float32)
        xi = np.ascontiguousarray(iq.imag, np.float32)
        _, _, _, batch = self.step_planes(xr, xi)
        t_loc = len(xr) // (self.n_time * self.channelizer.num_bands)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)

    def extract(self, x, fs: float, fc: float = 0.0,
                sample_start_time: float = 0.0) -> dict:
        """Full capture -> host PDW dict (decimated-rate TOAs and widths,
        absolute frequencies), ``create_pdws_channelized.m`` semantics."""
        _, _, batch = self.step(x)
        t_loc = len(x) // (self.n_time * self.channelizer.num_bands)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)

    def _finalize_merged(self, batch: PdwBatch, block_len_frames: int,
                         fs: float, fc: float, sample_start_time: float
                         ) -> dict:
        """Merge a block-stacked batch and finalize to the host PDW dict
        (decimated rate, absolute times and frequencies); under several
        processes, this process's pulses at capture-global indices."""
        merged = merge_block_batches(batch, block_len_frames)
        first = self.mesh.local_rows[0] * block_len_frames
        if first:
            for name in ("toa_idx", "te_idx"):
                v = getattr(merged, name)
                setattr(merged, name, np.where(merged.valid, v + first, -1))
        m = self.channelizer.num_bands
        return pdwmod.finalize_pdws(
            merged, fs=fs / m, fc=fc, sample_start_time=sample_start_time,
            bin_offsets_hz=self.channelizer.center_frequencies(fs))


def merge_block_batches(batch: PdwBatch, block_len_frames: int) -> PdwBatch:
    """Merge a block-stacked ``(n_time, M, max_pulses)`` batch into a
    per-channel ``(M, n_time*max_pulses)`` batch with capture-global sample
    indices (host-side NumPy; fields may be tensors or arrays)."""

    def f(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    toa, te, valid = f(batch.toa_idx), f(batch.te_idx), f(batch.valid)
    nt = toa.shape[0]
    off = (np.arange(nt, dtype=np.int64) * block_len_frames)[:, None, None]

    def tr(v):
        return np.moveaxis(v, 0, 1).reshape(v.shape[1], -1)

    return PdwBatch(
        toa_idx=tr(np.where(valid, toa + off, -1)),
        te_idx=tr(np.where(valid, te + off, -1)),
        pw_sec=tr(f(batch.pw_sec)),
        mag=tr(f(batch.mag)),
        snr_db=tr(f(batch.snr_db)),
        freq_offset_hz=tr(f(batch.freq_offset_hz)),
        saturated=tr(f(batch.saturated)),
        valid=tr(valid),
        count=f(batch.count).sum(axis=0),
    )


def sharded_extract_pdws(
    x,
    cfg: PdwConfig,
    mesh: Mesh,
    halo_samples: Optional[int] = None,
    strict_halo: bool = False,
) -> Tuple[PdwBatch, int]:
    """Time-sharded **wideband** PDW extraction (``create_pdws.m`` under
    sharding): the full-rate capture split over the time axis, the floor
    by the noise floor kernel on the whole magnitude (gathered along time),
    the latch chained across shards, halo-stitched pulses, and on each
    shard the kernel tail of the blocked wideband extractor
    (``dsp.pdw._extract_wideband_blocked``), its plain versions on the CPU.

    Returns ``(batch, block_len)`` with batch fields ``(rows, 1,
    max_pulses)``; merge with :func:`merge_block_batches` and finalize with
    ``finalize_pdws``.  Needs a chan axis of size 1.
    """
    if mesh.n_chan != 1:
        raise ValueError("wideband sharded extraction uses a (n_time, 1) mesh")
    cap = shard_capture(mesh, x)
    n = cap.n_samples
    if n % mesh.n_time:
        raise ValueError(f"{n} samples not divisible by {mesh.n_time} time "
                         f"shards")
    t_loc = n // mesh.n_time
    halo = _cap_halo(halo_samples or cfg.max_pulse_samples, t_loc, strict_halo)
    streams = {}
    for s, v in cap.parts.items():
        mag, ph, sat = pdwmod._prep_streams(v.to(torch.complex64),
                                            cfg.saturation_level)
        streams[s] = (mag[:, None], ph[:, None], sat[:, None])
    nf = {}
    for j, parts in mesh.gather_time({s: v[0][:, 0]
                                      for s, v in streams.items()}).items():
        nf[j] = pdwmod.noise_floor_1d(torch.cat(parts)).reshape(1)
    batches = _time_major_tail(mesh, cfg, streams, _per_shard(mesh, nf),
                               t_loc, halo, kernel=True)
    return _stack_batches(mesh, batches), t_loc


def sharded_channelize(
    x,
    chan: chmod.Channelizer,
    mesh: Mesh,
) -> torch.Tensor:
    """Standalone time/channel-sharded channelizer (exact overlap-save).

    Equals ``dsp.channelizer.channelize(x, chan)``: bit for bit with one
    mesh column, within DFT-vs-FFT rounding otherwise.  Returns this
    process's rows, ``(rows * t_loc, M)``.
    """
    m = chan.num_bands
    n_frames = len(x) // m
    if n_frames % mesh.n_time:
        raise ValueError(f"{n_frames} frames not divisible by {mesh.n_time} "
                         f"time shards")
    if m % mesh.n_chan:
        raise ValueError(f"num_bands {m} not divisible by chan mesh axis "
                         f"{mesh.n_chan}")
    pipe = ShardedPipeline(mesh, chan, PdwConfig.channelized())
    cap = shard_capture(mesh, x[: n_frames * m])
    t_loc = n_frames // mesh.n_time
    frames = pipe._frames([cap], t_loc, torch.complex64)
    return _assemble(mesh, pipe._channelize_oracle(frames, t_loc,
                                                    planes=False))
