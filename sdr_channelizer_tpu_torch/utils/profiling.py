"""Per-stage timing and profiler traces.

The reference's only tracing is timestamped progress prints
(``create_pdws.m:35,49``; per-dwell ``"Received N"`` prints,
``blade_record_iq_12bit.cpp:311``).  Here: a :class:`StageTimer` that times
named stages (ingest / channelize / detect / merge) on the host clock, each
closed by a synchronisation of the CUDA devices its output lives on, and
:func:`trace`, a ``torch.profiler`` window written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def sync_device(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` has
    finished its queued work; host values and CPU tensors need no wait."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StageTimer:
    """Accumulates wall-clock per named stage across repeated passes."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass the stage's output tree as ``sync``, append
        it to the yielded list, or call :func:`sync_device` yourself before
        leaving the block."""
        t0 = time.perf_counter()
        box: List = []
        try:
            yield box
        finally:
            target = box[0] if box else sync
            if target is not None:
                sync_device(target)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16s} {tot:8.3f} s  ({n} calls, {tot/n*1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (host, and the CUDA
    devices where there are any) and write a Chrome trace,
    ``<host>_<pid>.<ms>.pt.trace.json``, into ``log_dir``; no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
