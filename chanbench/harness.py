"""The benchmark of ``sdr_channelizer_tpu_torch``: one cell, one run.

    python3 chanbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds everything else by those names, so that a later cell brings
files and edits none:

* ``configs/<config>.json``: the deployment's sizes, guarantees and the
  entry it runs (``entries/<entry>.py``; a mix may name another entry);
* ``traffic/<mix>.json``: the mix's parameters, read by ``generator.py``
  (or by ``laws/<law>.py`` where the mix names a ``law``);
* ``limits/<cell>.json``: each compared number's limit;
* ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  a metric, ``read(result)``; a layer reader may ``install(run)`` itself
  before a traced window.

A run: set-up (the CUDA context, the pool of dwells made on the card from
``--seed`` and handed over as pageable host payloads, the entry built once
and warmed up on every item's shape), then a closed loop of one client for
``--seconds``: the next capture goes in when the last one's PDWs are back,
cycling through the pool.  With ``--trace 1`` the window, at most
``TRACE_WINDOW_S`` long, runs under ``torch.profiler`` and the run reports
the cell's per-layer metrics, else its end-to-end ones.  Then the program
is freed, the reference works the pool's PDWs out again, and the PDW dicts
the window kept (each item's first and a sample drawn from the seed,
``Sample``) are compared with their item's (``compare.py``).  The last line
on stdout is the result; the last lines on stderr are the numbers compared
beside their limits.

Exits 2 without a CUDA card (or with fewer than the cell asks for), 3 when
a JAX module is loaded.  ``--device cpu`` is a dry run for tests, on the
plain versions, with ``--set key=value`` to shrink the sizes; ``--control``
runs the reference in the configuration's lower precision in the
program's place, the check's control.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# a traced run's window: the profiler's reading of it grows with its events
TRACE_WINDOW_S = 10.0
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_channelizer_tpu")
SPAN_PREFIX = "chanbench."
# window outputs kept for the comparison beyond each item's first
SAMPLE = 64


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    whole name compared (``sdr_channelizer_tpu_torch`` is not one)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the harness, found by name."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"chanbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def staged_steps(*owners) -> list:
    """The staged steps among the attributes of ``owners`` (and the values
    of their dicts), known by their ``hits`` and ``misses`` counts and not
    by name, so that a program that renames, adds or drops a step needs no
    edit here."""
    found = []
    for owner in owners:
        for value in vars(owner).values():
            for obj in (value.values() if isinstance(value, dict)
                        else (value,)):
                if all(isinstance(getattr(obj, k, None), int)
                       and not isinstance(getattr(obj, k), bool)
                       for k in ("hits", "misses")):
                    found.append(obj)
    return found


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


class Run:
    """The run's spans: host seconds by name, and in a traced window a
    ``record_function`` range each, which names the device's idle gaps."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.tracing:
            yield
            return
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(
                    time.perf_counter() - t0)


class Sample:
    """The window's outputs that the comparison judges: each item's first,
    and a uniform sample of the rest drawn from the seed (a reservoir of
    ``SAMPLE``).  The others are dropped as they come, as ``pdw`` drops a
    dwell's PDWs once written, so that the window's host memory stays flat
    and no capture pays for pages that only the harness holds."""

    def __init__(self, n_items: int, seed: int):
        self.n_items = n_items
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.first: List[dict] = []
        self.rest: List[tuple] = []
        self.offered = 0

    def offer(self, k: int, out: dict) -> None:
        if k < self.n_items:
            self.first.append(out)
            return
        j = self.offered
        self.offered += 1
        if j < SAMPLE:
            self.rest.append((k, out))
        else:
            slot = int(self.rng.integers(j + 1))
            if slot < SAMPLE:
                self.rest[slot] = (k, out)

    def _kept(self) -> list:
        return (list(enumerate(self.first))
                + sorted(self.rest, key=lambda kv: kv[0]))

    def outputs(self) -> List[dict]:
        return [out for _, out in self._kept()]

    def items(self) -> List[int]:
        return [k % self.n_items for k, _ in self._kept()]


class Result:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse(argv):
    p = argparse.ArgumentParser(prog="chanbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cpu: a dry run on the plain versions, for tests")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="dry runs only: override a configuration or mix key")
    p.add_argument("--control", action="store_true",
                   help="the reference in the lower precision in the "
                        "program's place")
    return p.parse_args(argv)


def _overrides(args, cfg: dict, mix: dict) -> None:
    if args.set and args.device != "cpu":
        raise SystemExit("--set is for dry runs (--device cpu) only")
    for kv in args.set:
        key, val = kv.split("=", 1)
        target = mix if key in mix else cfg
        target[key] = json.loads(val)


def _device(args, chips: int):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chanbench: the cell needs {chips} CUDA device(s), this "
              f"machine has {have}", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _control_entry(cfg: dict, mix: dict, device):
    from chanbench import reference

    block = mix.get("block_frames") if mix.get("files_per_item", 1) > 1 \
        else None

    def call(item):
        return reference.pdws(cfg, item.payloads, item.start_times[0],
                              precision=cfg["control_precision"],
                              block_frames=block, device=device)
    return call


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bad = forbidden_modules()
    if bad:
        print(f"chanbench: JAX modules loaded at start: {bad}",
              file=sys.stderr)
        return 3
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    _overrides(args, cfg, mix)
    limits = load_json(HERE, "limits", cell["name"] + ".json")

    import torch

    from chanbench import compare, devtrace, generator, reference

    device = _device(args, int(cell["chips"]))
    tracing = bool(args.trace)
    run = Run(tracing)
    section = "per_layer" if tracing else "end_to_end"
    readers = {m["name"]: load_module(
        "layer_metrics" if tracing else "e2e_metrics", m["name"])
        for m in cell_metrics(bench, cell["name"], section)}

    tmp = tempfile.mkdtemp(prefix="chanbench-") \
        if mix.get("files_per_item", 1) > 1 else None
    try:
        return _run(args, bench, cell, cfg, mix, limits, device, run,
                    readers, tmp, t_start, torch, compare, devtrace,
                    generator, reference)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _run(args, bench, cell, cfg, mix, limits, device, run, readers, tmp,
         t_start, torch, compare, devtrace, generator, reference) -> int:
    from sdr_channelizer_tpu_torch.ops import cuda as kernels

    marks = [("start", t_start), ("imports", time.perf_counter())]
    law = load_module("laws", mix["law"]) if "law" in mix else generator
    items = law.make_pool(mix, cfg, args.seed, device, tmp)
    marks.append(("pool", time.perf_counter()))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if args.control:
        entry, graphs = _control_entry(cfg, mix, device), []
    else:
        emod = load_module("entries", mix.get("entry", cfg["entry"]))
        entry = emod.make(cfg, mix, run, device)
        graphs = entry.graphs()
    marks.append(("entry", time.perf_counter()))
    for item in items:               # every shape, every graph captured
        entry(item)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    if run.tracing:
        for reader in readers.values():
            if hasattr(reader, "install"):
                reader.install(run)
    misses0 = sum(g.misses for g in graphs)
    launches0 = sum(kernels.launch_counts().values())

    latencies, which = [], []
    kept = Sample(len(items), args.seed)
    prof = devtrace.start() if run.tracing else None
    seconds = min(args.seconds, TRACE_WINDOW_S) if run.tracing \
        else args.seconds
    faults0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    t_first = time.perf_counter()
    k = 0
    with run.span("window"):
        while time.perf_counter() - t_first < seconds:
            item = items[k % len(items)]
            t0 = time.perf_counter()
            with run.span("capture"):
                out = entry(item)
            latencies.append(time.perf_counter() - t0)
            kept.offer(k, out)
            which.append(k % len(items))
            out = None
            k += 1
    window_s = time.perf_counter() - t_first
    faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults0
    outputs, which_kept = kept.outputs(), kept.items()
    trace = devtrace.stop(prof) if prof is not None else None
    _sync(device)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    misses = sum(g.misses for g in graphs) - misses0
    launches = sum(kernels.launch_counts().values()) - launches0
    hits = sum(g.hits for g in graphs)
    samples = sum(items[i].samples for i in which)
    per_item_batches = getattr(entry, "batches", lambda item: 1)
    result = Result(
        cfg=cfg, mix=mix, cell=cell, run=run, trace=trace,
        latencies_s=latencies, captures=len(latencies),
        samples=samples, window_s=window_s, setup_s=t_first - t_start,
        samples_per_capture=samples / max(len(latencies), 1),
        batches_per_capture=float(np.mean(
            [per_item_batches(items[i]) for i in which])) if which else 1.0)
    metrics = {}
    section = "per_layer" if run.tracing else "end_to_end"
    units = {m["name"]: m["unit"] for m in bench[section]}
    for name, reader in readers.items():
        value = reader.read(result)
        if value is None or (isinstance(value, float) and math.isnan(value)):
            print(f"metric {name}: nothing to read", file=sys.stderr)
            continue
        metrics[name] = {"value": float(value), "unit": units[name]}

    card = _power_limit() if device.type == "cuda" else None
    print("set-up s: " + ", ".join(
        f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in
        enumerate(marks[1:])) + f"; to the first capture "
        f"{t_first - t_start:.3f}", file=sys.stderr)
    print(f"card {card or device}", file=sys.stderr)
    q = np.percentile(latencies, [10, 25, 50, 75, 90, 95, 99]) * 1e3
    print(f"captures {len(latencies)} in {window_s:.6f} s; ms at p10 p25 "
          f"p50 p75 p90 p95 p99 " + " ".join(f"{v:.6f}" for v in q)
          + f"; max {max(latencies) * 1e3:.6f}", file=sys.stderr)
    print(f"memory_peak_bytes {peak}; graphs hits {hits} misses in the "
          f"window {misses}; kernel launches a capture "
          f"{launches / max(len(latencies), 1):.3f}", file=sys.stderr)
    if misses:
        print("warning: a graph was captured inside the window",
              file=sys.stderr)
    print(f"outputs compared {len(outputs)} of {len(latencies)}: the first "
          f"of each item and a sample of at most {SAMPLE} drawn from the "
          f"seed; minor page faults in the window {faults}", file=sys.stderr)

    # the program's state goes before the reference runs
    entry = graphs = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    block = mix.get("block_frames") if mix.get("files_per_item", 1) > 1 \
        else None
    rate = float(cfg["sample_rate_sps"]) / int(cfg.get("num_bands", 1))
    found, failed, firsts, left, counts = None, 0, {}, {}, []
    for i, item in enumerate(items):
        if i not in which_kept:
            continue
        ref = reference.pdws(cfg, item.payloads, item.start_times[0],
                             block_frames=block, device=device)
        first_out = outputs[which_kept.index(i)]
        counts.append(f"{len(first_out['toa'])}/{len(ref['toa'])}")
        for out in (o for o, w in zip(outputs, which_kept) if w == i):
            first = firsts.get(i)
            if first is not None and compare.same(first[0], out):
                nums = first[1]
            else:
                try:
                    nums = compare.numbers(
                        out, ref, rate, item.start_times[0], rate,
                        int(cfg["max_pulses"]), block,
                        int(cfg["max_pulse_samples"]))
                except ValueError as e:      # a pulse emitted twice
                    print(f"item {i}: {e}", file=sys.stderr)
                    nums = dict.fromkeys(compare.NUMBERS, math.inf)
                left = {k: left.get(k, 0) + nums.get(k, 0)
                        for k in compare.COUNTS}
                if first is None:
                    firsts[i] = (out, nums)
            failed += not compare.verdict(nums, limits)
            found = compare.worst(found, nums)
        del ref
    correct = found is not None and failed == 0
    print(f"PDWs an item, program/reference: {' '.join(counts)}",
          file=sys.stderr)
    print(f"pulses left out over the distinct outputs compared: at a "
          f"threshold (unpaired not counted) {left.get('at_a_threshold')}, "
          f"at the wrap cut (no frequency held) {left.get('at_the_cut')}, "
          f"pairs whose saturation flag is not held "
          f"{left.get('flag_unheld')}",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"chanbench: JAX modules loaded: {bad}", file=sys.stderr)
        return 3

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(latencies),
            "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_ops(),
                             "idle_gaps": trace.idle_gaps()}
    if card:
        device_info["card"] = card
    checks = {k: {"value": (found or {}).get(k), "limit": limits[k]}
              for k in limits}
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
