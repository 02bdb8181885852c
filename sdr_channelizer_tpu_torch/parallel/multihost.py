"""Several processes: each reads only its own span of a capture and holds
its own time shards.

The reference is strictly single-host over USB (SURVEY.md section 5.8).
Here, as in the JAX package, each process of a ``torch.distributed`` group
reads only the dwell files that cover its own time shards
(:func:`host_local_time_range`), with no traffic for the rest of the
capture.  There is no global array: :func:`make_global_capture` lays this
process's span out over its shards of the mesh (a
:class:`~sdr_channelizer_tpu_torch.parallel.mesh.ShardedCapture`), which the
:class:`~sdr_channelizer_tpu_torch.parallel.pipeline.ShardedPipeline` steps
take as they are.  Their exchanges cross processes through the group: gloo
between CPU processes (and, through the host, between processes that share
one card: NCCL refuses two ranks on one GPU), NCCL between processes on
separate cards.  Start the processes as fresh interpreters (``spawn`` or a
subprocess) and call ``torch.distributed.init_process_group`` with the
address, world size and rank before :func:`~sdr_channelizer_tpu_torch.
parallel.mesh.make_mesh`.

:func:`launch_ranks` does all of that for a capture set on disk: it starts
one fresh interpreter a rank (:func:`rank_main`), each runs the sharded
steps of a job on its own span (:func:`run_capture_set`) and writes its
rows, which :func:`launch_ranks` returns in rank order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np

from sdr_channelizer_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedCapture,
    shard_capture,
)


def time_shard_bounds(n_samples: int, n_time: int) -> List[Tuple[int, int]]:
    """[start, end) sample range of each time shard (equal blocks)."""
    if n_samples % n_time:
        raise ValueError(f"{n_samples} samples not divisible by {n_time} shards")
    block = n_samples // n_time
    return [(i * block, (i + 1) * block) for i in range(n_time)]


def host_local_time_range(mesh: Mesh, n_samples: int) -> Tuple[int, int]:
    """The [start, end) sample range this process's shards own: the whole
    capture for one process, else the union of its time shards (contiguous,
    since a process holds a contiguous run of the grid)."""
    bounds = time_shard_bounds(n_samples, mesh.n_time)
    mine = sorted({s[0] for s in mesh.local_shards})
    if not mine:
        raise ValueError("this process owns no time shards of the mesh")
    return bounds[mine[0]][0], bounds[mine[-1]][1]


def make_global_capture(
    mesh: Mesh,
    local_samples,
    n_samples: int,
    local_start: int,
) -> ShardedCapture:
    """This process's time shards of a capture of ``n_samples``, from its
    local span ``[local_start, local_start + len(local_samples))``, each on
    its shard's device."""
    return shard_capture(mesh, local_samples, n_samples, local_start)


def ingest_capture_set(mesh: Mesh, segment, n_samples: int) -> ShardedCapture:
    """Read this process's span of a
    :class:`~sdr_channelizer_tpu_torch.dsp.streaming.Segment` (complex, as
    ``iqpacket.to_complex`` gives it) and lay it out over its shards; the
    files outside the span are not read."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    lo, hi = host_local_time_range(mesh, n_samples)
    parts = []
    pos = 0
    for path, hdr in zip(segment.paths, segment.headers):
        n = hdr.num_samples
        s, e = pos, pos + n
        if e > lo and s < hi:
            _, samples = iqpacket.read_iq(path)
            iq = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
            parts.append(iq[max(lo - s, 0): min(hi, e) - s])
        pos += n
        if pos >= hi:
            break
    local = np.concatenate(parts) if parts else np.zeros(0, np.complex64)
    return make_global_capture(mesh, local, n_samples, lo)


# ------------------------------------------------ a job over processes

FIELDS = ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db", "freq_offset_hz",
          "saturated", "valid", "count")


def _packed_span(segment, lo: int, hi: int) -> np.ndarray:
    """The packed integer pairs of samples ``[lo, hi)`` of ``segment``,
    read from the files that cover them only."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    parts, pos = [], 0
    for path, hdr in zip(segment.paths, segment.headers):
        s, e = pos, pos + hdr.num_samples
        if e > lo and s < hi:
            raw = np.asarray(iqpacket.read_iq(path)[1])
            parts.append(raw[max(lo - s, 0):min(hi, e) - s])
        pos = e
    raw = np.ascontiguousarray(np.concatenate(parts))
    return raw.view(np.int32 if raw.dtype == np.int16 else np.int16).ravel()


def _sync(devices) -> None:
    import torch

    for d in {str(d) for d in devices}:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def run_capture_set(directory: str, devices: Sequence, job: dict) -> dict:
    """The sharded steps of ``job`` on the capture set in ``directory`` (one
    segment of contiguous ``.iq`` files), on this process's ``devices``:
    this process's rows of each step, as host arrays.

    ``job`` holds ``channels`` (M), ``pdw`` (the
    :class:`~sdr_channelizer_tpu_torch.config.PdwConfig` fields),
    ``halo_frames`` and ``halo_mode`` of the pipelines, ``reps`` and
    ``runs``.  A run is ``{"name": prefix, "mesh": [n_time, n_chan],
    "step": "step" | "packed", "route": ..., "eager": bool}``: ``"step"``
    is the oracle step on the complex samples (:func:`ingest_capture_set`),
    ``"packed"`` the fused step on the packed payload at the files' bit
    width (:func:`make_global_capture` of this process's span); the steps
    are staged, or with ``"eager"`` their eager forms.  A run gives
    ``<name>nf``, ``<name><field>`` for each of :data:`FIELDS`,
    ``<name>span`` (``[lo, hi)`` read) and, with ``reps`` > 0,
    ``<name>step_ms``: the median host-clock time of that many steps after
    one, every device synchronised."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet
    from sdr_channelizer_tpu_torch.parallel.mesh import make_mesh
    from sdr_channelizer_tpu_torch.parallel.pipeline import ShardedPipeline

    seg = CaptureSet.from_dir(directory).segments[0]
    n = seg.num_samples
    chan = Channelizer.create(int(job["channels"]))
    cfg = PdwConfig(**job["pdw"])
    out = {}
    for run in job["runs"]:
        name = run["name"]
        mesh = make_mesh(*run["mesh"], devices=devices)
        lo, hi = host_local_time_range(mesh, n)
        pipe = ShardedPipeline(mesh, chan, cfg,
                               halo_frames=job.get("halo_frames"),
                               halo_mode=job.get("halo_mode", "warn"))
        pipe._eager = bool(run.get("eager", False))
        if run["step"] == "step":
            cap = ingest_capture_set(mesh, seg, n)

            def step():
                _, nf, batch = pipe.step(cap)
                return nf, batch
        else:
            cap = make_global_capture(mesh, _packed_span(seg, lo, hi), n, lo)
            bit_width = seg.headers[0].bit_width

            def step():
                return pipe.step_packed(cap, bit_width=bit_width,
                                        route=run.get("route", "auto"))
        nf, batch = step()
        out[name + "nf"] = nf.cpu().numpy()
        for f in FIELDS:
            out[name + f] = getattr(batch, f).cpu().numpy()
        out[name + "span"] = np.array([lo, hi])
        if job.get("reps", 0):
            times = []
            for _ in range(job["reps"]):
                _sync(devices)
                t0 = time.perf_counter()
                step()
                _sync(devices)
                times.append((time.perf_counter() - t0) * 1e3)
            out[name + "step_ms"] = np.median(times)
    return out


def rank_main(argv: Sequence[str]) -> None:
    """One rank of :func:`launch_ranks`: ``RANK WORLD PORT DIRECTORY
    BACKEND DEVICE [DEVICE ...]``.  Joins the group at
    ``tcp://127.0.0.1:PORT``, runs ``DIRECTORY/job.json`` on its devices
    (:func:`run_capture_set`) and writes ``DIRECTORY/rank<RANK>.npz``."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, world, port, directory, backend = (
        int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4])
    devices = [torch.device(d) for d in argv[5:]]
    if any(d.type == "cpu" for d in devices):
        # the plain versions' float32 products may sum in an order that
        # follows the thread count: one thread, as the one-process run
        torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        out = run_capture_set(directory, devices, job)
        np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(directory: str, job: dict, rank_devices: Sequence[Sequence],
                 backend: str = "gloo", timeout: float = 240) -> List[dict]:
    """Run ``job`` (:func:`run_capture_set`) on the capture set in
    ``directory`` over ``len(rank_devices)`` processes, rank ``r`` on the
    devices ``rank_devices[r]``, joined by a ``backend`` group on a free
    localhost port.  Waits at most ``timeout`` seconds for each process,
    kills what is left, and raises with a failed rank's log; returns the
    ranks' outputs in rank order."""
    if dataclasses.is_dataclass(job["pdw"]):
        job = dict(job, pdw=dataclasses.asdict(job["pdw"]))
    with open(os.path.join(directory, "job.json"), "w") as f:
        json.dump(job, f)
    world, port = len(rank_devices), _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    code = ("import sys; from sdr_channelizer_tpu_torch.parallel.multihost "
            "import rank_main; rank_main(sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), str(world), str(port),
         directory, backend, *[str(d) for d in devs]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank, devs in enumerate(rank_devices)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {rank} exited {p.returncode}:\n{log[-4000:]}")
    return [dict(np.load(os.path.join(directory, f"rank{r}.npz")))
            for r in range(world)]
