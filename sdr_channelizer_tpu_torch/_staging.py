"""Staged steps: the port's counterpart of ``jax.jit`` with
``static_argnames``.

``Staged(fn, device, static_argnames)`` wraps a function of tensors.  On a
CUDA device it keeps one captured ``torch.cuda.CUDAGraph`` a key; the key
holds the device, each array argument's shape, dtype and contiguity, the
static arguments and the ``allow_tf32`` switch.

* The first call on a key copies the inputs into static buffers it owns,
  runs ``fn`` once eagerly on a side stream (that builds the kernels and
  fills the wrappers' caches: the channelizer's device weights, the noise
  floor kernel's per-device attributes), then captures ``fn`` into a graph
  with a memory pool of its own.
* Every call copies the inputs in, replays the graph and returns clones
  of the outputs, ``PdwBatch`` fields included, so that each call's
  results are its own, as ``jax.jit``'s are.  A host source of at least
  ``PINNED_MIN_BYTES`` is copied into page-locked memory on the host's
  threads and from there to the device in one queued DMA
  (:func:`_pinned_copy`), and the call goes on once the host has read the
  source's last byte; a smaller one is copied straight into its buffer.
  The replay and the clones are queued on the same stream after the
  copies, so they wait for the data without a host sync.
* On the card a call records the spans ``staged.capture`` (the eager
  run and the capture, a miss) or ``staged.copy_in`` (a hit, with the
  counters ``staged.copy_in_bytes``, the bytes from the host, and
  ``staged.copy_in_ring_bytes``, those that went through page-locked
  memory), then ``staged.replay`` and ``staged.clone``
  (``utils.profiling``; nothing while spans are off).
* At most ``MAX_GRAPHS`` keys are kept, the least recently used dropped
  first: each graph's pool holds the step's peak memory.
* A replay runs no Python, so the kernel wrappers' launch counts would
  miss it: the counts the capture added are taken back and added again on
  every replay.  Device state that a wrapper keeps from call to call and
  the graph reads by address is held with the graph (:func:`keep_alive`).
* A capture that fails (a host sync, a shape that depends on the data, a
  launch error) raises :class:`StagingError`, naming the key; nothing runs
  the eager form on the card in its place.
* On the CPU there is no graph: the staged function calls ``fn``, a host
  array argument handed over as a tensor, as on the card.
* A positional argument may be ``None`` (a block with no history): the key
  holds that it is, and ``fn`` gets ``None`` in its place.

What the function reads besides its array arguments (a pipeline's
configuration and taps) is frozen into the graph at capture, as ``jax.jit``
freezes it at trace time.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import threading
import warnings
import weakref
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch.utils import profiling

MAX_GRAPHS = 4
# host sources of this many bytes or more reach the device through
# page-locked memory: on an H100's host a 58.7 MB dwell then holds the host
# 2.5-2.7 ms where a pageable copy held it 8.9-10.9, in memory or read from
# a file's map, and a streamed block of 65,536 frames of 56 bands (14.7 MB)
# 1.4 ms where it held it 3.1; smaller ones (a block's history, a floor)
# keep the pageable copy
PINNED_MIN_BYTES = 12 << 20

_capturing = threading.local()   # .held: the capture's kept tensors


class StagingError(RuntimeError):
    """A staged function could not be captured as a CUDA graph."""


def keep_alive(*tensors: torch.Tensor) -> None:
    """Hold ``tensors`` for as long as the graph being captured on this
    thread, if one is: state that a wrapper keeps between calls (and may
    drop) and the graph reads by address.  Outside a capture it does
    nothing."""
    held = getattr(_capturing, "held", None)
    if held is not None:
        held.extend(tensors)


def map_tensors(fn: Callable, obj):
    """``obj`` with ``fn`` applied to every tensor in it: through tuples,
    lists, dicts and dataclass instances (a ``PdwBatch``)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _torch_dtype(x: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


def _array_key(x) -> tuple:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.is_contiguous()
    if isinstance(x, np.ndarray):
        return x.shape, _torch_dtype(x), bool(x.flags.c_contiguous)
    raise TypeError(f"a staged function's positional arguments are tensors, "
                    f"arrays or None, got {type(x).__name__}; pass other values "
                    f"by name as static arguments")


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A host array as a tensor on the host, sharing its memory where it
    can."""
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    # a payload read from disk may be read-only; it is only read
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(x)


def _pinned(shape: torch.Size, dtype: torch.dtype) -> torch.Tensor:
    """A page-locked host tensor from torch's caching host allocator."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _pinned_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the host tensor ``src`` into the device tensor ``dst`` of its
    shape and dtype: into a page-locked tensor first (torch's copy between
    host tensors, on its intra-op threads and without the GIL), then one
    DMA queued on the current stream.  Returns once the host has read
    ``src``, the DMA still queued; the allocator hands the page-locked
    block out again only after the event that the DMA recorded, and makes
    a block at the first copy of its size (a capture's)."""
    stage = _pinned(src.shape, src.dtype)
    stage.copy_(src)
    dst.copy_(stage, non_blocking=True)


def _launch_counts() -> dict:
    from sdr_channelizer_tpu_torch.ops import cuda as kernels

    return kernels.launch_counts()


def _add_launch_counts(delta: dict) -> None:
    from sdr_channelizer_tpu_torch.ops import cuda as kernels

    kernels.add_launch_counts(delta)


def _reasons(e: BaseException) -> str:
    """The error and the ones it was raised in the handling of, the first
    first: a failed capture's cause (a host sync) is the context of the
    error that ends the capture."""
    out = []
    while e is not None and len(out) < 4:
        out.append(f"{type(e).__name__}: {str(e).splitlines()[0]}"
                   if str(e) else type(e).__name__)
        e = e.__cause__ or e.__context__
    return " -> ".join(reversed(out))


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list         # the static buffers the graph reads
    outputs: object      # fn's outputs, in the graph's pool
    launches: dict       # each wrapper's launches in one replay
    held: list           # state the graph reads besides its buffers


class Staged:
    """``fn`` staged on ``device``: a CUDA graph a key on the card, ``fn``
    itself on the CPU; see the module docstring.  Raises, as
    :func:`resolve_device` does, when the card is asked for and there is
    none.  ``hits`` and ``misses`` count the calls on the card that found
    their key's graph and that captured one."""

    def __init__(self, fn: Callable, device: Union[str, torch.device, None],
                 static_argnames: Iterable[str] = ()):
        self.device = resolve_device(device)
        self.static_argnames = frozenset(static_argnames)
        self.name = getattr(fn, "__qualname__", repr(fn))
        # a bound method is held weakly: its owner holds this object
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def fn(self) -> Callable:
        """The function staged: its eager form."""
        return self._fn()

    def key(self, *args, **static) -> tuple:
        """The graph key of a call with these arguments."""
        self._check_static(static)
        return (str(self.device), tuple(_array_key(x) for x in args),
                tuple(sorted(static.items())),
                torch.backends.cuda.matmul.allow_tf32)

    def __len__(self) -> int:
        return len(self._graphs)

    def _check_static(self, static: dict) -> None:
        unknown = set(static) - self.static_argnames
        if unknown:
            raise TypeError(f"{self.name}: {sorted(unknown)} are not static "
                            f"arguments ({sorted(self.static_argnames)})")

    def __call__(self, *args, **static):
        fn = self._fn()
        key = self.key(*args, **static)   # the same checks on either device
        if self.device.type != "cuda":
            return fn(*(_host_tensor(x) if isinstance(x, np.ndarray) else x
                        for x in args), **static)
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                self.misses += 1
                with profiling.span("staged.capture"):
                    entry = self._capture(fn, key, args, static)
            else:
                self.hits += 1
                self._graphs.move_to_end(key)
                with profiling.span("staged.copy_in"):
                    host_bytes, pinned_bytes = self._copy_in(entry.inputs,
                                                             args)
                    profiling.count("staged.copy_in_bytes", host_bytes)
                    if pinned_bytes:
                        profiling.count("staged.copy_in_ring_bytes",
                                        pinned_bytes)
            with profiling.span("staged.replay"):
                entry.graph.replay()
                _add_launch_counts(entry.launches)
            with profiling.span("staged.clone"):
                return map_tensors(torch.Tensor.clone, entry.outputs)

    def _buffer(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            return torch.empty(x.shape, dtype=_torch_dtype(x),
                               device=self.device)
        # the strides of a dense tensor, else contiguous
        return torch.empty_like(x, device=self.device)

    @staticmethod
    def _copy_in(buffers: list, args) -> Tuple[int, int]:
        """Copy ``args`` into ``buffers``: a host source of at least
        ``PINNED_MIN_BYTES`` through page-locked memory, any other straight
        in.  Returns the bytes that came from the host and those of them
        that went through page-locked memory."""
        host_bytes = pinned_bytes = 0
        for buf, x in zip(buffers, args):
            if buf is None:
                continue
            src = _host_tensor(x) if isinstance(x, np.ndarray) else x
            if src.is_cuda:
                buf.copy_(src)
                continue
            host_bytes += src.nbytes
            if src.nbytes >= PINNED_MIN_BYTES:
                _pinned_copy(buf, src)
                pinned_bytes += src.nbytes
            else:
                buf.copy_(src)
        return host_bytes, pinned_bytes

    def _capture(self, fn: Callable, key: tuple, args, static) -> _Graph:
        inputs = [self._buffer(x) for x in args]
        self._copy_in(inputs, args)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(*inputs, **static)        # launches, and is counted
        stream.wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        held = []
        _capturing.held = held
        try:
            with torch.cuda.graph(graph, stream=side):
                outputs = fn(*inputs, **static)
        except Exception as e:
            raise StagingError(f"{self.name}: capture failed for key "
                               f"{key}: {_reasons(e)}") from e
        finally:
            _capturing.held = None
            captured = {k: n - before[k] for k, n in _launch_counts().items()
                        if n != before[k]}
            # the capture recorded these launches; the replays make them
            _add_launch_counts({k: -n for k, n in captured.items()})
        entry = _Graph(graph, inputs, outputs, captured, held)
        self._graphs[key] = entry
        if len(self._graphs) > MAX_GRAPHS:
            # the dropped graph may still be replaying
            torch.cuda.synchronize(self.device)
            self._graphs.popitem(last=False)
        return entry

