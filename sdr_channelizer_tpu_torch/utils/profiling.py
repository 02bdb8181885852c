"""Per-stage timing, profiler traces, and the program's spans and counters.

The reference's only tracing is timestamped progress prints
(``create_pdws.m:35,49``; per-dwell ``"Received N"`` prints,
``blade_record_iq_12bit.cpp:311``).  Here: a :class:`StageTimer` that times
named stages (ingest / channelize / detect / merge) on the host clock, each
closed by a synchronisation of the CUDA devices its output lives on, and
:func:`trace`, a ``torch.profiler`` window written as a Chrome trace.

The program's own spans and counters go to one :class:`Recorder`,
``RECORDER``, through the module's :func:`span`, :func:`count`,
:func:`enable`, :func:`disable`, :func:`snapshot` and :func:`report`.  Off
(the default) a span is one shared no-op context: no clock, no allocation,
no profiler range.  On, each span is kept in memory (name, start and end on
``time.perf_counter_ns``, the enclosing span, the capture: the outermost
span, an ``entry.*`` call) and, while a profiler records, opens a
``torch.profiler.record_function`` range named ``<prefix><name>``, so that
the profile lays the program's spans on the clock of the device's
activities.  Where the spans sit:

* ``entry.<method>``: the pipelines' ``extract*`` calls and the streamed
  path's ``extract_segment*``, the root of a capture;
* ``staged.copy_in`` (counter ``staged.copy_in_bytes``, the bytes copied
  from the host), ``staged.replay`` (the graph's launch), ``staged.clone``
  (the outputs' copies) and ``staged.capture`` in ``_staging.Staged``;
* ``finalize.wait`` (the step's tail, only while spans are on),
  ``finalize.d2h`` and ``finalize.host`` in ``dsp.pdw.finalize_pdws``;
* ``stream.read``, ``stream.floor`` and ``stream.to_host`` in the block
  loop of ``dsp.streaming``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from sdr_channelizer_tpu_torch.utils.metrics import Counters

DEFAULT_PREFIX = "sdr_channelizer_tpu_torch."


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


@dataclasses.dataclass
class SpanRecord:
    """One span: ``parent`` and ``capture`` are indices into the recorder's
    spans (``parent`` -1 at a root, ``capture`` the root's own index);
    ``end_ns`` is None while the span is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    capture: int


class _Span:
    """An open span of a recorder that is on."""

    __slots__ = ("_rec", "_name", "_log", "_index", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self._name = name

    # the clock is read outside the profiler range, so that a span's time
    # holds the cost of its own range and its parent's self time does not
    def __enter__(self):
        start = time.perf_counter_ns()
        rec = self._rec
        stack = rec._stack()
        with rec._lock:
            log = self._log = rec._log
            self._index = len(log)
            # a span left open across enable() starts no tree in the new log
            top = stack[-1] if stack and stack[-1][0] is log else None
            parent = -1 if top is None else top[1]
            capture = self._index if top is None else log[parent].capture
            log.append(SpanRecord(self._name, start, None, parent, capture))
        stack.append((log, self._index))
        # a range costs about ten microseconds, and only a profile reads it
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                rec.prefix + self._name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec._stack().pop()
        self._log[self._index].end_ns = time.perf_counter_ns()
        return False


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters of the program, kept in memory while on."""

    def __init__(self):
        self.on = False
        self.prefix = DEFAULT_PREFIX
        self.counters = Counters()
        self._log: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A context that records the span ``name`` while the recorder is
        on; off, the one shared no-op context."""
        if not self.on:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the counter ``name`` while the recorder is on."""
        if self.on:
            with self._lock:
                self.counters.add(name, n)

    def enable(self, prefix: Optional[str] = None) -> None:
        """Clear the recorder and turn it on; its profiler ranges are named
        ``<prefix><span>`` (by default the program's name)."""
        with self._lock:
            self._log = []
            self.counters = Counters()
            self.prefix = DEFAULT_PREFIX if prefix is None else prefix
            self.on = True

    def disable(self) -> None:
        """Turn the recorder off; what it holds stays readable."""
        self.on = False

    def records(self) -> List[SpanRecord]:
        """The spans recorded since :meth:`enable`, in the order opened."""
        with self._lock:
            return list(self._log)

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
        {name: value}}`` over the closed spans: a span's self time is its
        duration less that of its children (on its own thread, one after
        another)."""
        log = self.records()
        covered = [0] * len(log)
        for r in log:
            if r.end_ns is not None and r.parent >= 0:
                covered[r.parent] += r.end_ns - r.start_ns
        spans: Dict[str, dict] = {}
        for r, kids in zip(log, covered):
            if r.end_ns is None:
                continue
            ns = r.end_ns - r.start_ns
            s = spans.setdefault(r.name,
                                 {"count": 0, "total_s": 0.0, "self_s": 0.0})
            s["count"] += 1
            s["total_s"] += ns * 1e-9
            s["self_s"] += (ns - kids) * 1e-9
        return {"spans": spans, "counters": dict(self.counters.values)}

    def report(self) -> str:
        """The spans' self times in :meth:`StageTimer.report`'s format."""
        spans = self.snapshot()["spans"]
        return StageTimer(
            totals={k: v["self_s"] for k, v in spans.items()},
            counts={k: v["count"] for k, v in spans.items()}).report()


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
enable = RECORDER.enable
disable = RECORDER.disable
records = RECORDER.records
snapshot = RECORDER.snapshot
report = RECORDER.report


def enabled() -> bool:
    """Whether the program's spans are on."""
    return RECORDER.on


def spanned(name: str) -> Callable:
    """Decorate a function to run inside the span ``name``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
