"""Shared pieces of the benchmark's tests: tiny dry runs on the CPU."""

import contextlib
import io
import json
import os
import sys

from chanbench import harness

ROOT = harness.ROOT
# sizes a CPU test can hold: 4096 frames of 56 bands, 2 items
TINY = ["--set", "dwell_samples=229376", "--set", "pool=2"]
TINY_STREAM = TINY + ["--set", "block_frames=1024",
                      "--set", "max_pulse_samples=256"]


def tiny_args(cell: str) -> list:
    return TINY_STREAM if cell == "ch56_stream" else TINY


def dry_run(cell: str, seed: int = 5, seconds: float = 0.5, trace: int = 0,
            extra=()) -> tuple:
    """``harness.main`` in this process on the CPU: (exit code, result
    line or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu",
            *tiny_args(cell), *extra]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def bench() -> dict:
    return harness.load_json(ROOT, "BENCHMARK.json")


def python_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


PY = sys.executable
