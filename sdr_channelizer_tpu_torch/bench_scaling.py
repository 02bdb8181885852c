"""Scaling benchmark of the port: samples/s through the sharded pipeline at
mesh sizes 1, 2, 4, ... devices.

    python -m sdr_channelizer_tpu_torch.bench_scaling [--fused]
        [--bands 64] [--frames-per-device 65536] [--iters 5]
        [--chan-split 1] [--fixed-total] [--cpu-devices N]

The counterpart of the JAX package's root ``bench_scaling.py``.  The mesh
sizes run up to the CUDA devices present (one card gives size 1 alone), or
up to N with ``--cpu-devices N``: a mesh of N shards on the host, which
checks the harness and the exchanges, not a speed.  Each size runs
``ShardedPipeline.step_packed`` on the packed int16 payload (``--fused``,
the kernels) or ``step`` on the complex capture (the oracle), staged (a
CUDA graph a stage and device, replayed; the exchanges between the
replays); the capture is copied from the host on every step.  A step is
timed by the host clock over ``--iters`` steps, every device of the mesh
synchronised before and after.  ``--fixed-total`` shards the same capture
at every size, so the ratio to size 1 measures the sharding's overhead
rather than its scaling.

Prints one JSON line per mesh size and, with more than one size, a
summary line, every number unrounded (a slow host mesh reads well under
0.1 Msamples/s, which a fixed number of places would print as zero);
diagnostics go to stderr, among them each size's eager step (the stages'
functions launched from the host), timed the same way after the staged
one, to four significant digits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> int:
    from sdr_channelizer_tpu_torch._device import resolve_device
    from sdr_channelizer_tpu_torch.bench import places
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    ap = argparse.ArgumentParser(
        prog="sdr_channelizer_tpu_torch.bench_scaling",
        description="sharded channelize -> PDW throughput at mesh sizes "
                    "1, 2, 4, ...")
    ap.add_argument("--bands", type=int, default=64)
    ap.add_argument("--frames-per-device", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chan-split", type=int, default=1,
                    help="channel-axis size of the mesh (rest goes to time)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="a mesh of this many shards on the host instead of "
                         "the CUDA devices")
    ap.add_argument("--fixed-total", action="store_true",
                    help="strong scaling: shard the same total capture at "
                         "every mesh size, so value/value[1] measures the "
                         "sharding's overhead")
    ap.add_argument("--fused", action="store_true",
                    help="the fused sharded step (the channelizer kernel a "
                         "shard, packed int16 ingest: the multi-card form "
                         "of the bench headline); needs --chan-split 1")
    args = ap.parse_args(argv)
    if args.fused and args.chan_split != 1:
        ap.error("--fused shards time only; use --chan-split 1")
    if args.cpu_devices:
        devices = [torch.device("cpu")] * args.cpu_devices
    else:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    sizes = [1 << k for k in range(len(devices).bit_length())]

    chan = Channelizer.create(args.bands)
    cfg = PdwConfig.channelized(max_pulses=256, max_pulse_samples=1024)
    rng = np.random.default_rng(0)

    results = {}
    for nd in sizes:
        n_chan = (args.chan_split
                  if nd % args.chan_split == 0 and nd >= args.chan_split
                  else 1)
        n_time = nd // n_chan
        mesh = make_mesh(n_time=n_time, n_chan=n_chan, devices=devices[:nd])
        pipe = ShardedPipeline(mesh, chan, cfg)
        total_time = max(sizes) if args.fixed_total else n_time
        n = args.bands * args.frames_per_device * total_time
        x = (0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
        if args.fused:
            i16 = np.clip(np.round(np.stack([x.real, x.imag], -1) * 2048),
                          -2048, 2047).astype(np.int16)
            xq = i16.view(np.int32).ravel()

            def step():
                return pipe.step_packed(xq, bit_width=12)
        else:
            def step():
                return pipe.step(x)

        def sync():
            for d in set(devices[:nd]):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        def seconds_a_step() -> float:
            step()
            sync()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                step()
            sync()
            return (time.perf_counter() - t0) / args.iters

        dt = seconds_a_step()
        msps = n / dt / 1e6
        pipe._eager = True
        eager = seconds_a_step()
        pipe._eager = False
        print(f"bench_scaling: {n_time}x{n_chan} staged "
              f"{dt * 1e3:.{places(dt * 1e3)}f} ms/step, eager "
              f"{eager * 1e3:.{places(eager * 1e3)}f} ms/step "
              f"({n / eager / 1e6:.{places(n / eager / 1e6)}f} Msamples/s)",
              file=sys.stderr)
        results[nd] = msps
        if args.fixed_total:
            eff = msps / results[1] if nd > 1 else 1.0
        else:
            eff = msps / (results[1] * nd) if nd > 1 else 1.0
        print(json.dumps({
            "metric": "sharded_throughput", "devices": nd,
            "mesh": f"{n_time}x{n_chan}", "value": msps,
            "unit": "Msamples/s",
            ("overhead_efficiency" if args.fixed_total
             else "scaling_efficiency"): eff,
        }), flush=True)

    if len(results) > 1:
        top = max(results)
        if args.fixed_total:
            eff = results[top] / results[1]
            name = "sharding_overhead_efficiency"
        else:
            eff = results[top] / (results[1] * top)
            name = "scaling_efficiency"
        print(json.dumps({
            "metric": name, "value": eff,
            "unit": f"1->{top} devices", "vs_baseline": eff / 0.8,
        }), flush=True)
    print("done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
