"""The (time x chan) device mesh, its three exchanges and a capture laid
out over it.

Axis semantics (``config.ShardingConfig``):

* ``time`` -- the capture's sample axis, cut into contiguous blocks;
  neighbouring blocks exchange FIR history and pulse halos (the reference's
  analog is one dwell file per time window,
  ``blade_record_iq_12bit.cpp:287-325``).
* ``chan`` -- the channelizer's output bands; PDW extraction is independent
  across bands (``create_pdws_channelized.m:79`` loops bins in turn), and
  the channel extraction's DFT product is split by columns, so each shard
  computes its own bands only.

A mesh is an ``(n_time, n_chan)`` grid of ``(rank, torch.device)``: the
process that holds each shard and the device it runs on there, plus the
``torch.distributed`` process group it spans (None for one process).  A
device may appear more than once: shards that share a card run one after
the other on it (the CPU tests build a mesh of ``["cpu"] * 8``).

The exchanges are written out where ``shard_map``'s collectives did them
(``ppermute`` right and left, ``all_gather`` along time).  Between shards of
one process they are copies between the shards' devices; between processes
they go through the group, point to point for the neighbours and as an
all-gather along time.  A gloo group carries CPU tensors only, so a CUDA
tensor that crosses it goes through the host, and only what crosses a
process boundary is staged so.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device, to_device

TIME_AXIS = "time"
CHAN_AXIS = "chan"

Shard = Tuple[int, int]  # (time row, chan column)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``(n_time, n_chan)`` grid of ``(rank, device)`` and the process
    group it spans.  Build it with :func:`make_mesh`."""

    grid: Tuple[Tuple[Tuple[int, torch.device], ...], ...]
    group: Optional[object] = None
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {TIME_AXIS: len(self.grid), CHAN_AXIS: len(self.grid[0])}

    @property
    def n_time(self) -> int:
        return len(self.grid)

    @property
    def n_chan(self) -> int:
        return len(self.grid[0])

    def owner(self, s: Shard) -> int:
        return self.grid[s[0]][s[1]][0]

    def device(self, s: Shard) -> torch.device:
        return self.grid[s[0]][s[1]][1]

    def is_local(self, s: Shard) -> bool:
        return self.owner(s) == self.rank

    @property
    def local_shards(self) -> List[Shard]:
        """This process's shards, time-major."""
        return [(i, j) for i in range(self.n_time) for j in range(self.n_chan)
                if self.grid[i][j][0] == self.rank]

    @property
    def local_rows(self) -> Tuple[int, int]:
        """``[lo, hi)``: the time rows whose shards this process holds."""
        rows = sorted({i for i, _ in self.local_shards})
        return rows[0], rows[-1] + 1

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where results are
        assembled."""
        return self.device(self.local_shards[0])

    def column_home(self, j: int) -> torch.device:
        """The device of this process's first shard of chan column ``j``."""
        return next(self.device(s) for s in self.local_shards if s[1] == j)

    @property
    def local_columns(self) -> List[int]:
        return sorted({j for _, j in self.local_shards})

    # ------------------------------------------------------------ exchanges

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` crosses the group through the host (a gloo group
        carries CPU tensors only)."""
        import torch.distributed as dist

        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def _shift(self, parts: Dict[Shard, torch.Tensor], d: int
               ) -> Dict[Shard, Optional[torch.Tensor]]:
        """Every local shard ``(i, j)`` receives the part of ``(i + d, j)``,
        on its own device; None where that shard is off the grid."""
        out, recvs, ops, sent = {}, [], [], []
        for s in self.local_shards:
            src = (s[0] + d, s[1])
            if not 0 <= src[0] < self.n_time:
                out[s] = None
            elif self.is_local(src):
                out[s] = parts[src].to(self.device(s))
            else:
                import torch.distributed as dist

                mine = parts[s]
                buf = torch.empty_like(mine, device="cpu") \
                    if self._staged(mine) else torch.empty_like(mine)
                ops.append(dist.irecv(buf, self.owner(src), self.group,
                                      tag=self._tag(s)))
                recvs.append((s, buf))
        for s in self.local_shards:
            dst = (s[0] - d, s[1])
            if 0 <= dst[0] < self.n_time and not self.is_local(dst):
                import torch.distributed as dist

                t = parts[s].contiguous()
                t = t.cpu() if self._staged(t) else t
                sent.append(t)  # alive until its send completes
                ops.append(dist.isend(t, self.owner(dst), self.group,
                                      tag=self._tag(dst)))
        for op in ops:
            op.wait()
        for s, buf in recvs:
            out[s] = buf.to(self.device(s))
        return out

    def _tag(self, receiver: Shard) -> int:
        return receiver[0] * self.n_chan + receiver[1]

    def send_right(self, parts: Dict[Shard, torch.Tensor]
                   ) -> Dict[Shard, Optional[torch.Tensor]]:
        """Each shard's part goes to its right (next in time) neighbour: a
        shard receives its left neighbour's part, row 0 None (``ppermute``
        over ``[(j, j + 1)]``).  ``parts`` holds every local shard's part,
        all of one shape and dtype."""
        return self._shift(parts, -1)

    def send_left(self, parts: Dict[Shard, torch.Tensor]
                  ) -> Dict[Shard, Optional[torch.Tensor]]:
        """Each shard's part goes to its left neighbour: a shard receives
        its right neighbour's part, the last row None."""
        return self._shift(parts, 1)

    def gather_time(self, parts: Dict[Shard, torch.Tensor]
                    ) -> Dict[int, List[torch.Tensor]]:
        """The all-gather along time: for each chan column ``j`` this
        process holds, the ``n_time`` parts of that column in time order,
        on ``column_home(j)``.  ``parts`` as in :meth:`send_right`."""
        if self.group is None:
            return {j: [parts[(i, j)].to(self.column_home(j))
                        for i in range(self.n_time)]
                    for j in self.local_columns}
        import torch.distributed as dist

        mine = [parts[s] for s in self.local_shards]
        is_bool = mine[0].dtype == torch.bool
        stack = torch.stack([p.to(torch.uint8) if is_bool else p
                             for p in mine])
        if self._staged(stack):
            stack = stack.cpu()
        world = dist.get_world_size(self.group)
        bufs = [torch.empty_like(stack) for _ in range(world)]
        dist.all_gather(bufs, stack.contiguous(), group=self.group)
        flat = torch.cat(bufs)  # ranks hold contiguous runs of the grid
        if is_bool:
            flat = flat.to(torch.bool)
        return {j: [flat[i * self.n_chan + j].to(self.column_home(j))
                    for i in range(self.n_time)]
                for j in self.local_columns}


def make_mesh(
    n_time: Optional[int] = None,
    n_chan: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build a ``(time, chan)`` mesh over ``devices`` (default: every CUDA
    device; with none, raises as ``resolve_device`` does).

    ``devices`` may repeat a device: shards then share it.  Once
    ``torch.distributed``'s default group is initialised, ``devices`` are
    this process's, the mesh runs over every process's devices in rank
    order (the world group), and each process holds a contiguous run of the
    grid, the same number of shards each, in whole time rows.
    ``n_time`` defaults to the device count over ``n_chan``.  Time is the
    major axis, so neighbouring time blocks sit on neighbouring devices.
    """
    if devices is None:
        resolve_device(None)  # raises without a card
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() \
        else None
    rank = 0
    if group is None:
        pairs = [(0, d) for d in devs]
    else:
        rank = dist.get_rank(group)
        names: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(names, [str(d) for d in devs], group=group)
        pairs = [(r, torch.device(d)) for r, ds in enumerate(names)
                 for d in ds]
    if n_time is None:
        if len(pairs) % n_chan:
            raise ValueError(
                f"{len(pairs)} devices not divisible by n_chan={n_chan}")
        n_time = len(pairs) // n_chan
    need = n_time * n_chan
    if need > len(pairs):
        raise ValueError(
            f"mesh {n_time}x{n_chan} needs {need} devices, have {len(pairs)}")
    used = pairs[:need]
    if group is not None:
        held = np.bincount([r for r, _ in used],
                           minlength=dist.get_world_size(group))
        if len(set(held.tolist())) != 1 or held[0] % n_chan:
            raise ValueError(f"every process must hold as many shards of "
                             f"the mesh, in whole time rows of {n_chan}; "
                             f"they hold {held.tolist()}")
    grid = tuple(tuple(used[i * n_chan:(i + 1) * n_chan])
                 for i in range(n_time))
    return Mesh(grid=grid, group=group, rank=rank)


# ------------------------------------------------------- a sharded capture

@dataclasses.dataclass
class ShardedCapture:
    """A 1-D capture of ``n_samples`` laid out over a mesh: ``parts[(i,
    j)]`` is time block ``i`` on the device of shard ``(i, j)``, for this
    process's shards only.  A chan column's shards hold the same block."""

    n_samples: int
    parts: Dict[Shard, torch.Tensor]


def shard_capture(mesh: Mesh, x, n_samples: Optional[int] = None,
                  start: int = 0) -> ShardedCapture:
    """Lay ``x`` out over ``mesh``.  ``x`` is the whole capture, or with
    ``n_samples`` and ``start`` this process's span ``[start, start +
    len(x))`` of a capture of ``n_samples``, which must cover its shards.
    A :class:`ShardedCapture` is returned as it is."""
    if isinstance(x, ShardedCapture):
        return x
    n = len(x) if n_samples is None else n_samples
    if n % mesh.n_time:
        raise ValueError(
            f"{n} samples not divisible by {mesh.n_time} time shards")
    block = n // mesh.n_time
    parts, placed = {}, {}
    for s in mesh.local_shards:
        lo, hi = s[0] * block, (s[0] + 1) * block
        if lo < start or hi > start + len(x):
            raise ValueError(f"shard [{lo},{hi}) outside this process's span "
                             f"[{start},{start + len(x)})")
        key = (s[0], mesh.device(s))  # shards of a row on one device share
        if key not in placed:
            placed[key] = to_device(x[lo - start:hi - start], mesh.device(s))
            if placed[key].ndim != 1:
                raise ValueError("a capture is a 1-D array")
        parts[s] = placed[key]
    return ShardedCapture(n_samples=n, parts=parts)
