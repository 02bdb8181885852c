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

Staged steps (the JAX package's six ``jax.jit`` sites, ``_staging``).  A
``jax.jit`` step holds its collectives; a CUDA graph cannot hold the
exchanges, so each step is cut at them into stages, each a ``Staged``
function of one shard's tensors (of one mesh column's for the floor), one
``Staged`` a stage and device, a graph a key:

* channelize: a shard's frames with the FIR history and (route cm2) the
  halo head it received, through the channelizer kernel with its column's
  band slice, or the oracle's FIR and DFT and the detection streams;
* floor: a column's owned magnitudes gathered along time, their median
  (the noise floor kernel on the fused routes and wideband), then every
  row's latch transfer and, by an exclusive prefix of ``compose_transfer``
  in shard order, every row's latch entry;
* tail: a shard's streams with their halo, its floor and entry, through
  the extraction with the block contract; the shard's row, a 0-d device
  tensor, puts the last row's +inf latch past the capture's end, so that
  one graph serves every row.

The exchanges (``Mesh.send_right``, ``send_left``, ``gather_time``) run
eagerly between the replays, on each device's current stream.  On the CPU
a stage is its function; the private switch ``_eager`` runs the stages'
functions without graphs on the card too (the last row's latch then a
copy on that row alone, every other row's the stream itself).
``sharded_extract_pdws`` and ``sharded_channelize`` keep their staged
pipeline while the mesh lives.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch._staging import MAX_GRAPHS, Staged
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

# each stage of the staged steps and its static arguments
_STAGES = {
    "_chan_cm2": ("col", "bit_width"),
    "_chan_cm": ("col", "bit_width"),
    "_chan_oracle": ("col", "prep"),
    "_prep_wideband": (),
    "_floor_cm2": (),
    "_floor_cm": (),
    "_floor_median": (),
    "_floor_1d": (),
    "_tail_cm2": ("own_len",),
    "_tail_tm": ("own_len", "kernel"),
}


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


def _two(xs) -> tuple:
    """One or two planes' values as two positional arguments, the second
    None for one plane."""
    return (*xs, None)[:2]


def _past_end(x: torch.Tensor, last, start: int = 0) -> torch.Tensor:
    """``x`` with +inf from column ``start`` on if ``last``: the latch's
    magnitude past the capture's end on the last row.  In a staged stage
    ``last`` is a 0-d bool tensor, so that one graph serves every row; in
    the eager form it is a host bool: a copy on the last row, ``x`` itself
    on every other."""
    if isinstance(last, bool):
        if not last:
            return x
        x = x.clone()
        x[:, start:] = float("inf")
        return x
    if start:
        cols = torch.arange(x.shape[1], device=x.device)
        last = last & (cols >= start)
    return torch.where(last, float("inf"), x)


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

    The steps are staged (the module docstring): each stage captured once
    a key as a CUDA graph on its device and replayed; what a stage reads
    besides its tensors (the taps, the band slices, the configuration) is
    frozen at capture, as ``jax.jit`` freezes it at trace time.
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
        # the stages' Staged functions by (stage, device), made at first
        # use; ``_eager`` runs the stages' functions instead
        self._eager = False
        self._staged: Dict[Tuple[str, str], Staged] = {}
        self._rows: Dict[Shard, torch.Tensor] = {}
        self._oracle_w: dict = {}

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

    # ------------------------------------------------------------ staging

    def _row(self, s: Shard):
        """Shard ``s``'s time row, a tail stage's input: a 0-d int64 tensor
        on its device, so that one graph serves every row, or where the
        pipeline runs eagerly the row itself (:func:`_past_end`)."""
        if self._eager:
            return s[0]
        row = self._rows.get(s)
        if row is None:
            row = self._rows[s] = torch.tensor(s[0], dtype=torch.int64,
                                               device=self.mesh.device(s))
        return row

    def _stage(self, name: str, device: torch.device):
        """Stage ``name`` (a method in ``_STAGES``) on ``device``: its
        ``Staged`` function, made at first use, or the method itself where
        the pipeline runs eagerly."""
        fn = getattr(self, name)
        if self._eager:
            return fn
        key = (name, str(device))
        staged = self._staged.get(key)
        if staged is None:
            staged = self._staged[key] = Staged(fn, device, _STAGES[name])
        return staged

    def _floor(self, name: str, owned) -> Tuple[dict, torch.Tensor]:
        """Floor stage ``name`` on each of this process's mesh columns, on
        ``column_home``, the columns' owned magnitudes gathered along time:
        each local shard's ``(nf, entry)`` on its device, and the floor
        (M,) on home."""
        mesh = self.mesh
        col = {j: self._stage(name, mesh.column_home(j))(*parts)
               for j, parts in mesh.gather_time(owned).items()}
        per = {s: (col[s[1]][0].to(mesh.device(s)),
                   col[s[1]][1][s[0]].to(mesh.device(s)))
               for s in mesh.local_shards}
        return per, torch.cat([col[j][0].to(mesh.home) for j in sorted(col)])

    def _entries(self, nf: torch.Tensor, owned) -> torch.Tensor:
        """Every row's latch entry state, ``(n_time, m_loc)``, from the
        owned ``(m_loc, t_loc)`` blocks of a column in time order: each
        block's transfer function, then an exclusive prefix of
        ``compose_transfer`` (not commutative) in shard order; row 0 enters
        inactive."""
        cfg = self.pdw_cfg
        acc, entry = None, []
        for part in owned:
            f = pdwmod.block_transfer(part, nf[:, None], cfg.snr_threshold_db,
                                      cfg.trailing_threshold_db)
            entry.append(torch.zeros_like(f[0]) if acc is None else acc[0])
            acc = f if acc is None else pdwmod.compose_transfer(acc, f)
        return torch.stack(entry)

    def _tm_tail(self, streams, per, t_loc: int, halo: int, kernel: bool
                 ) -> Dict[Shard, PdwBatch]:
        """Each local shard's batch from its time-major (t_loc, m_loc)
        detection streams ``(mag, phase_deg, sat)`` and its ``per`` shard
        ``(nf, entry)``: the three streams' right halo comes left (zeros on
        the last row, whose tail reads +inf magnitude there), then the tail
        stage: the kernel tail (``kernel``) or the oracle block core.
        ``streams`` is emptied shard by shard as each is extracted."""
        mesh = self.mesh
        heads = [mesh.send_left({s: v[k][:halo] for s, v in streams.items()})
                 for k in range(3)]
        out = {}
        for s in mesh.local_shards:
            v = streams.pop(s)
            h = [torch.zeros_like(v[k][:halo]) if heads[k][s] is None
                 else heads[k][s] for k in range(3)]
            out[s] = self._stage("_tail_tm", mesh.device(s))(
                *v, *h, *per[s], self._row(s), own_len=t_loc, kernel=kernel)
        return out

    # ------------------------------------------------------------- stages

    def _chan_fused(self, planes, hist, col: int, bit_width: int, forms):
        """The channelizer kernel's form ``forms[len(planes)]`` on a shard's
        (T, M) frames of one or two planes, with the FIR history ``hist``
        (None on row 0: the zero initial state) and column ``col``'s band
        slice."""
        hist = [h.reshape(-1) for h in hist if h is not None]
        history = None if not hist else (
            hist[0] if len(planes) == 1 else tuple(hist))
        return forms[len(planes)](
            *(f.reshape(-1) for f in planes), self.channelizer.taps_rev,
            history=history, bit_width=bit_width,
            sat_level=self.pdw_cfg.saturation_level,
            w_parts=self._w_slice(col))

    def _chan_cm2(self, f0, f1, h0, h1, d0, d1, *, col: int,
                  bit_width: int):
        """Route cm2's channelize stage on one shard: its (t_loc, M) frames
        of one or two planes (``f1`` None for the packed payload), the FIR
        history it received (None on row 0) and the next shard's first
        ``halo`` frames (zeros on the last row), through the channelizer
        kernel's channel-major form: ``(mag_cm, dph_cm, satcs_cm)``, (m_loc,
        t_loc + halo) each."""
        ext = [torch.cat([f, d]) for f, d in ((f0, d0), (f1, d1))
               if f is not None]
        return self._chan_fused(ext, (h0, h1), col, bit_width, {
            1: kernels.KERNELS.channelize,
            2: kernels.KERNELS.channelize_planes})

    def _chan_cm(self, f0, f1, h0, h1, *, col: int, bit_width: int):
        """Route cm's channelize stage on one shard: the channelizer
        kernel's flat form on its frames with the FIR history it received,
        the time-major (t_loc, m_loc) ``(mag, phase_deg, sat)``."""
        return self._chan_fused([f for f in (f0, f1) if f is not None],
                                (h0, h1), col, bit_width, {
                                    1: kernels.KERNELS.channelize_flat,
                                    2: kernels.KERNELS.channelize_flat_planes})

    def _oracle_weights(self, device: torch.device, col: int, planes: bool):
        """The taps and mesh column ``col``'s DFT columns on ``device``
        (complex, or their real and imaginary planes; None where one mesh
        column takes the FFT), made once: a captured stage reads them by
        address."""
        key = (str(device), col, planes)
        hit = self._oracle_w.get(key)
        if hit is None:
            w = self._w_cols(col)
            if planes:
                w = tuple(torch.as_tensor(np.ascontiguousarray(v),
                                          device=device)
                          for v in (w.real, w.imag))
            elif self.n_chan == 1:
                w = None
            else:
                w = torch.as_tensor(np.ascontiguousarray(w), device=device)
            hit = self._oracle_w[key] = (
                torch.as_tensor(self.channelizer.taps_rev, device=device), w)
        return hit

    def _chan_oracle(self, f0, f1, h0, h1, *, col: int, prep: bool):
        """The oracle's channelize stage on one shard: the branch FIR over
        its (t_loc, M) frames (complex, or two float32 planes) with the
        history it received, then the FFT (one mesh column, complex) or the
        product with column ``col``'s DFT slice.  Returns the bands ``y``
        (or ``(yr, yi)``), with ``prep`` followed by their detection
        streams ``(mag, phase_deg, sat)``."""
        taps, w = self._oracle_weights(f0.device, col, f1 is not None)
        level = self.pdw_cfg.saturation_level
        if f1 is not None:
            ur, ui = (chmod.fir_branches(f, taps, h)
                      for f, h in ((f0, h0), (f1, h1)))
            wr, wi = w
            y = (ur @ wr - ui @ wi, ur @ wi + ui @ wr)
            return (*y, *pdwmod._prep_streams_planes(*y, level)) if prep \
                else y
        u = chmod.fir_branches(f0, taps, h0)
        y = chmod._bands(u, self.channelizer.num_bands, True, "fft") \
            if w is None else u @ w
        return (y, *pdwmod._prep_streams(y, level)) if prep else y

    def _prep_wideband(self, x):
        """Wideband's prep stage on one shard: the (t_loc, 1) detection
        streams of its complex samples."""
        return tuple(v[:, None] for v in pdwmod._prep_streams(
            x.to(torch.complex64), self.pdw_cfg.saturation_level))

    def _floor_cm2(self, *owned):
        """Route cm2's floor stage on a mesh column: its ``n_time`` owned
        channel-major (m_loc, t_loc) magnitudes in time order -> ``(nf,
        entries)``: the noise floor kernel on them gathered into one (m_loc,
        T) buffer (the grid has no pad columns to mask), then every row's
        latch entry (:meth:`_entries`)."""
        buf = torch.cat(owned, dim=1)
        nf = pdwmod.noise_floor_cm(buf, buf.shape[0], buf.shape[1])
        return nf, self._entries(nf, owned)

    def _floor_cm(self, *mags):
        """Route cm's floor stage: :meth:`_floor_cm2` on the time-major
        (t_loc, m_loc) magnitudes turned channel-major."""
        return self._floor_cm2(*(m.T.contiguous() for m in mags))

    def _floor_median(self, *mags):
        """The oracle's floor stage: the median over time of the
        time-major (t_loc, m_loc) magnitudes, then every row's entry."""
        nf = median(torch.cat(mags), dim=0)
        return nf, self._entries(nf, [m.T for m in mags])

    def _floor_1d(self, *mags):
        """Wideband's floor stage: the noise floor kernel's one row on the
        (t_loc,) magnitudes joined, as a (1,) floor, then every row's
        entry."""
        nf = pdwmod.noise_floor_1d(torch.cat(mags)).reshape(1)
        return nf, self._entries(nf, [m[None] for m in mags])

    def _tail_cm2(self, mag_cm, dph_cm, satcs_cm, nf, entry, row, *,
                  own_len: int):
        """Route cm2's tail stage on one shard: its (m_loc, t_loc + halo)
        streams, floor and latch entry -> its ``PdwBatch`` by the cm2 tail
        with the block contract.  On the last row (``row``, :meth:`_row`)
        the latch reads +inf magnitude past ``own_len``, so that a pulse
        still open at the capture's end never closes."""
        latch = _past_end(mag_cm, row == self.n_time - 1, own_len)
        return pdwmod._extract_channelized_cm2(
            mag_cm, dph_cm, satcs_cm, self.pdw_cfg, nf, mag_cm.shape[1],
            mag_cm.shape[0], entry_active=entry, own_len=own_len,
            mag_latch_cm=latch)

    def _tail_tm(self, mag, ph, sat, hm, hp, hs, nf, entry, row, *,
                 own_len: int, kernel: bool):
        """The time-major tail stage on one shard: its (t_loc, m_loc)
        streams and the next shard's first ``halo`` rows of each (zeros on
        the last row, whose magnitude head reads +inf: past the capture's
        end), its floor and latch entry -> its ``PdwBatch`` by the kernel
        tail (``kernel``) or the oracle block core."""
        hm = _past_end(hm, row == self.n_time - 1)
        mag_e = torch.cat([mag, hm])
        ph_e = torch.cat([ph, hp])
        sat_e = torch.cat([sat, hs]).to(torch.bool)
        if kernel:
            return pdwmod._extract_channelized_pallas_stats(
                mag_e, ph_e, sat_e, self.pdw_cfg, nf, entry_active=entry,
                own_len=own_len)
        return pdwmod.extract_pdws_block_core(
            mag_e.T, ph_e.T, sat_e.T, nf, entry, own_len=own_len,
            **pdwmod._core_kwargs(self.pdw_cfg))

    # --------------------------------------------------------- the oracle

    def _oracle(self, frames, t_loc: int, prep: bool):
        """Each local shard's oracle channelize stage (:meth:`_chan_oracle`)
        after the FIR history's exchange."""
        hist = self._history(frames, t_loc)
        return {s: self._stage("_chan_oracle", self.mesh.device(s))(
            *_two(fs_), *_two(hist[s]), col=s[1], prep=prep)
            for s, fs_ in frames.items()}

    def step(self, x):
        """The oracle step on a complex capture.  Returns ``(chan_iq
        (rows * t_loc, M), noise_floor (M,), batch)``."""
        cap = self._capture(x)
        t_loc, halo, _ = self._geometry(cap.n_samples, fused=False)
        out = self._oracle(self._frames([cap], t_loc, torch.complex64),
                           t_loc, prep=True)
        per, nf = self._floor("_floor_median",
                              {s: v[1] for s, v in out.items()})
        y = _assemble(self.mesh, {s: v[0] for s, v in out.items()})
        streams = {s: v[1:] for s, v in out.items()}
        del out
        batches = self._tm_tail(streams, per, t_loc, halo, kernel=False)
        return y, nf, _stack_batches(self.mesh, batches)

    def step_planes(self, xr, xi):
        """The complex-free oracle step on float32 sample planes.  Returns
        ``(yr, yi, noise_floor, batch)``."""
        caps = [self._capture(xr), self._capture(xi)]
        t_loc, halo, _ = self._geometry(caps[0].n_samples, fused=False)
        out = self._oracle(self._frames(caps, t_loc, torch.float32), t_loc,
                           prep=True)
        per, nf = self._floor("_floor_median",
                              {s: v[2] for s, v in out.items()})
        yr = _assemble(self.mesh, {s: v[0] for s, v in out.items()})
        yi = _assemble(self.mesh, {s: v[1] for s, v in out.items()})
        streams = {s: v[2:] for s, v in out.items()}
        del out
        batches = self._tm_tail(streams, per, t_loc, halo, kernel=False)
        return yr, yi, nf, _stack_batches(self.mesh, batches)

    # ------------------------------------------------------- fused routes

    def _step_cm2(self, caps: List[ShardedCapture], bit_width: int):
        """The cm2 composition: each shard's raw (P-1)-frame tail goes right
        as FIR history and the next shard's first ``halo`` raw frames come
        left; the channelizer kernel's channel-major form runs on ``t_loc +
        halo`` frames with its band slice (the last shard's head is zeros),
        the floor is taken on the owned columns, the latch is chained, and
        the cm2 tail extracts with the block contract (latch magnitude +inf
        past the capture's end on the last shard).  The saturation count is
        per shard: the tail only ever differences it."""
        mesh = self.mesh
        t_loc, halo, _ = self._geometry(caps[0].n_samples, fused=True)
        frames = self._frames(caps, t_loc)
        hist = self._history(frames, t_loc)
        heads = [mesh.send_left({s: f[k][:halo] for s, f in frames.items()})
                 for k in range(len(caps))]
        streams = {}
        for s, fs_ in frames.items():
            ds = [f.new_zeros((halo, f.shape[1])) if h[s] is None else h[s]
                  for f, h in zip(fs_, heads)]
            streams[s] = self._stage("_chan_cm2", mesh.device(s))(
                *_two(fs_), *_two(hist[s]), *_two(ds), col=s[1],
                bit_width=bit_width)
        del frames, heads, hist
        per, nf = self._floor("_floor_cm2",
                              {s: v[0][:, :t_loc] for s, v in streams.items()})
        batches = {s: self._stage("_tail_cm2", mesh.device(s))(
            *streams.pop(s), *per[s], self._row(s), own_len=t_loc)
            for s in mesh.local_shards}
        return nf, _stack_batches(mesh, batches)

    def _step_cm(self, caps: List[ShardedCapture], bit_width: int,
                 stats: str):
        """Route cm: the channelizer kernel's flat form on each shard's
        block with its FIR history and band slice, the floor on the owned
        magnitudes, then the time-major tail with the three streams' halo."""
        mesh = self.mesh
        t_loc, halo, _ = self._geometry(caps[0].n_samples, fused=True)
        kernel = pdwmod._kernel_tail(stats, next(iter(caps[0].parts.values())))
        frames = self._frames(caps, t_loc)
        hist = self._history(frames, t_loc)
        streams = {s: self._stage("_chan_cm", mesh.device(s))(
            *_two(fs_), *_two(hist[s]), col=s[1], bit_width=bit_width)
            for s, fs_ in frames.items()}
        del frames, hist
        per, nf = self._floor("_floor_cm",
                              {s: v[0] for s, v in streams.items()})
        return nf, _stack_batches(mesh, self._tm_tail(streams, per, t_loc,
                                                      halo, kernel))

    def _wideband(self, cap: ShardedCapture, t_loc: int, halo: int
                  ) -> PdwBatch:
        """The wideband step (:func:`sharded_extract_pdws`) on a capture
        laid out over the mesh."""
        streams = {s: self._stage("_prep_wideband", self.mesh.device(s))(v)
                   for s, v in cap.parts.items()}
        per, _ = self._floor("_floor_1d",
                             {s: v[0][:, 0] for s, v in streams.items()})
        return _stack_batches(self.mesh, self._tm_tail(streams, per, t_loc,
                                                       halo, kernel=True))

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


# the staged pipelines behind the free functions, by the id of their mesh:
# a kept pipeline holds its mesh weakly, and the mesh's finalizer drops its
# entry, so that dropping the mesh frees its pipelines and their graphs at
# once (no cycle waits for the collector, which device memory never runs)
_KEPT: Dict[int, Dict[tuple, ShardedPipeline]] = {}


def _mesh_pipeline(mesh: Mesh, key: tuple, make) -> ShardedPipeline:
    """The staged pipeline behind a free function's calls over ``mesh``:
    ``make(proxy)`` at the first call with ``key`` (the function and its
    parameters), ``proxy`` a weak proxy of the mesh, then kept while the
    mesh lives, so that a later call replays its graphs; of more than
    ``MAX_GRAPHS`` the least recently used is dropped."""
    kept = _KEPT.get(id(mesh))
    if kept is None:
        kept = _KEPT[id(mesh)] = {}
        weakref.finalize(mesh, _KEPT.pop, id(mesh), None)
    pipe = kept.pop(key, None)
    if pipe is None:
        pipe = make(weakref.proxy(mesh))
    kept[key] = pipe
    if len(kept) > MAX_GRAPHS:
        kept.pop(next(iter(kept)))
    return pipe


def _wideband_pipeline(mesh: Mesh, cfg: PdwConfig) -> ShardedPipeline:
    """The staged pipeline of :func:`sharded_extract_pdws` on ``mesh`` with
    ``cfg`` (no channelizer: its wideband stages need none)."""
    return _mesh_pipeline(mesh, ("wideband", cfg),
                          lambda m: ShardedPipeline(m, None, cfg))


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
    Its stages are staged, kept while the mesh lives for later calls.

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
    return _wideband_pipeline(mesh, cfg)._wideband(cap, t_loc, halo), t_loc


def sharded_channelize(
    x,
    chan: chmod.Channelizer,
    mesh: Mesh,
) -> torch.Tensor:
    """Standalone time/channel-sharded channelizer (exact overlap-save).

    Equals ``dsp.channelizer.channelize(x, chan)``: bit for bit with one
    mesh column, within DFT-vs-FFT rounding otherwise.  Returns this
    process's rows, ``(rows * t_loc, M)``.  Its stage is staged, kept while
    the mesh lives for later calls with ``chan``.
    """
    m = chan.num_bands
    n_frames = len(x) // m
    if n_frames % mesh.n_time:
        raise ValueError(f"{n_frames} frames not divisible by {mesh.n_time} "
                         f"time shards")
    if m % mesh.n_chan:
        raise ValueError(f"num_bands {m} not divisible by chan mesh axis "
                         f"{mesh.n_chan}")
    # keyed by identity: the kept pipeline holds ``chan``
    pipe = _mesh_pipeline(mesh, ("channelize", id(chan)), lambda m:
                          ShardedPipeline(m, chan, PdwConfig.channelized()))
    cap = shard_capture(mesh, x[: n_frames * m])
    t_loc = n_frames // mesh.n_time
    return _assemble(mesh, pipe._oracle(
        pipe._frames([cap], t_loc, torch.complex64), t_loc, prep=False))
