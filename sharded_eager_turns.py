"""The sharded cm2 step of one tree of the port, eager and staged, on one
card: run it once a tree, in turns, to compare two commits.

    python3 sharded_eager_turns.py [--tree DIR] [--label NAME] [--reps 5]
    python3 sharded_eager_turns.py --count-ops [--tree DIR]

Imports ``sdr_channelizer_tpu_torch`` from ``DIR`` (a checkout of the
port; this script's own by default) and, from this script's directory,
``chip_smoke.py``'s main path: its dense and sparse captures (M = 64 x
262144, packed at bit width 12), ``PdwConfig.channelized(512, 1024)``, its
timer (``time_ms``, CUDA events) and its meshes (4, 1) and (2, 2) of four
shards on one card.  For each mesh and capture it times
``ShardedPipeline.step_packed``:

* a tree that stages the sharded steps: the eager form (the private
  ``_eager`` switch) and the staged one in turns (eager, staged, staged,
  eager), each the median of ``--reps`` calls after one warm-up;
* a tree from before (every sharded step eager): the step four times, each
  the median of ``--reps`` calls after one warm-up.

Prints one JSON line: the card's name and power limit (``nvidia-smi``), the
package's path, each cell's readings in ms, and a digest of each cell's
stacked batch, so that two trees' outputs can be compared bit for bit.
Exits 2 without a card.

``--count-ops`` needs no card: it counts the ATen operations that one
eager ``step_packed`` dispatches (a ``TorchDispatchMode``), at meshes
(4, 1) and (2, 2) of four shards on the host, M = 16, 2048 frames of a
seeded random payload at bit width 12, and prints them by operation as one
JSON line: the host's share of an eager step, which the card's clock
cannot separate from its noise.  The kernel wrappers run their plain
versions there, the same code in every tree.

To hold a change against its parent on the same card, in one run:

    mkdir -p _parent && git archive HEAD~1 | tar x -C _parent
    for t in _parent . . _parent; do python3 sharded_eager_turns.py \\
        --tree $t --label $t; done
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import chip_smoke as smoke


def _digest(batch) -> str:
    h = hashlib.sha256()
    for f in ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db",
              "freq_offset_hz", "saturated", "valid", "count"):
        h.update(getattr(batch, f).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def count_ops(args) -> int:
    """The ``--count-ops`` mode (the module docstring)."""
    import collections

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    sys.path.insert(0, os.path.abspath(args.tree))
    import sdr_channelizer_tpu_torch as port
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    torch.set_num_threads(1)
    m, frames = 16, 2048
    rng = np.random.default_rng(0)
    xq = smoke.pack(rng.integers(-2000, 2000, size=(m * frames, 2)
                                 ).astype(np.int16))
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)
    out = {}
    for nt, nc in smoke.SHARD_MESHES:
        spipe = ShardedPipeline(make_mesh(nt, nc, devices=["cpu"] * 4),
                                Channelizer.create(m), cfg)
        spipe._eager = True
        spipe.step_packed(xq, 12)
        with Count() as c:
            spipe.step_packed(xq, 12)
        out[f"{nt}x{nc}"] = {"total": sum(c.ops.values()),
                             "ops": dict(sorted(c.ops.items()))}
    print(json.dumps({"tree": args.label or args.tree,
                      "package": os.path.dirname(port.__file__),
                      "count_ops": out}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if args.count_ops:
        return count_ops(args)
    if not torch.cuda.is_available():
        print("sharded_eager_turns: no CUDA device", file=sys.stderr)
        return 2
    # the tree's package ahead of everything else on the path
    sys.path.insert(0, os.path.abspath(args.tree))
    import sdr_channelizer_tpu_torch as port
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    card = smoke.phase_env()
    smoke.phase_build()
    pipe = smoke.main_pipe()
    caps = smoke.main_captures()
    dev = torch.device(smoke.DEVICE, 0)
    cells = {}
    staged = None
    for nt, nc in smoke.SHARD_MESHES:
        spipe = ShardedPipeline(
            make_mesh(nt, nc, devices=[dev] * smoke.SHARD_DEVICES),
            pipe.channelizer, pipe.pdw_cfg)
        staged = hasattr(spipe, "_stage")
        for name, samples in caps.items():
            xq = torch.as_tensor(smoke.pack(samples), device=dev)

            def step():
                return spipe.step_packed(xq, smoke.BIT_WIDTH)

            cell = {"eager": [], "staged": []}
            for which in ("eager", "staged", "staged", "eager"):
                form = which if staged else "eager"
                spipe._eager = form == "eager"
                cell[form].append(smoke.time_ms(step, reps=args.reps,
                                                warmup=1))
            spipe._eager = False
            batch = step()[1]
            cell["digest"] = _digest(batch)
            cell["pulses"] = int(batch.count.sum())
            cells[f"{nt}x{nc} {name}"] = cell
            del xq
        del spipe
        torch.cuda.empty_cache()
    print(json.dumps({"tree": args.label or args.tree,
                      "package": os.path.dirname(port.__file__),
                      "card": card, "staged_steps": staged,
                      "reps": args.reps, "cells": cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
