"""Headline benchmark of the port: channelize -> noise floor -> PDWs on one
card, in complex Msamples/s.

    python -m sdr_channelizer_tpu_torch.bench [--stages] [--planes]
        [--bands 64] [--frames 262144] [--iters 120] [--rounds 5]
        [--device DEV | --cpu]

The counterpart of the JAX package's root ``bench.py``: the 64-band
polyphase channelizer, the per-band median noise floor and PDW extraction
(the ``create_pdws_channelized.m`` chain) through
``ChannelizerPipeline.forward_packed`` on the raw recorder payload, at two
operating points:

* **dense**: full-scale tones mid-transition-band, so every channel's
  512-pulse slot capacity nearly fills with 1-2 sample edge transients
  (the worst case for the per-pulse statistics);
* **sparse**: the reference's fixture regime (``generate_training_iq.m:16-22``:
  two active channels, a few hundred real pulses), bin-centred tones 24 dB
  over the noise floor.

The reference's operating point is keeping up with a 56 Msps radio;
``vs_baseline`` is the multiple of that rate the dense point sustains.

Timing protocol, on a CUDA card: the payloads go to the card first; a
CUDA event is recorded before and after ``--iters`` (K) consecutive steps
on the current stream, and the step is the elapsed time over K, so the
host's launches overlap the device's work as they do in a stream of
captures.  This repeats for ``--rounds`` (R) rounds, dense and sparse in
turns within each round; ``value``, ``sparse_msps`` and ``latency_p50_ms``
come from the median over rounds and ``rep_spread_pct`` is the dense
rounds' (max - min) / median.  ``device_step_ms`` is one dense step
captured as a CUDA graph and replayed K times between two events: the
device's time without the host's launch overhead.  Pulse counts come from
a warm-up step, outside the timed window.  On the CPU (``--cpu``, for
tests) the host clock takes the events' place and there is no graph.

Nothing falls back: without a card and without ``--cpu`` / ``--device
cpu`` the run raises.  Prints exactly one JSON line to stdout; diagnostics
go to stderr.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BASELINE_MSPS = 56.0   # the reference radio's rate
WARMUP_STEPS = 2       # a payload's steps before timing (the first builds)


def make_capture(n: int, bands: int, sparse: bool = False) -> np.ndarray:
    """``n`` complex64 samples of noise plus two pulsed tones at ``fs =
    bands`` MHz: the dense or sparse operating point (module docstring)."""
    rng = np.random.default_rng(0)
    fs = bands * 1e6
    t = np.arange(n)
    iq = (0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    if sparse:
        amp, trains = 0.02, [(1.0e6, 100e-6, 1e-3), (-8.0e6, 50e-6, 0.7e-3)]
    else:
        amp, trains = 1.0, [(1.3e6, 100e-6, 1e-3), (-7.6e6, 50e-6, 0.7e-3)]
    for k, (f0, pw, pri) in enumerate(trains):
        tone = (amp * np.exp(2j * np.pi * f0 / fs * t)).astype(np.complex64)
        pw_n, pri_n = int(pw * fs), int(pri * fs)
        for s in range(137 + k * 1000, n - pw_n, pri_n):
            iq[s:s + pw_n] = tone[s:s + pw_n]
    return iq


def quantize(cap: np.ndarray) -> np.ndarray:
    """complex64 in [-1, 1) -> interleaved Q11 int16 pairs (the recorder
    payload)."""
    return np.clip(np.round(np.stack([cap.real, cap.imag], -1) * 2048),
                   -2048, 2047).astype(np.int16)


def _planes(i16: np.ndarray, dev: torch.device):
    """The float32 sample planes of an int16 payload, normalised by 2048."""
    return tuple(torch.as_tensor(np.ascontiguousarray(
        i16[:, k].astype(np.float32) / 2048.0), device=dev) for k in (0, 1))


def _steps_ms(step: Callable, iters: int, dev: torch.device):
    """Milliseconds a step over ``iters`` consecutive steps, and the host's
    milliseconds a step to launch them.  On the card the first is read
    between two CUDA events; where the two agree, the host's launches, not
    the device, set the step.  On the CPU both are the host clock's."""
    a = b = None
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    host = (time.perf_counter() - t0) * 1e3 / iters
    if a is None:
        return host, host
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters, host


def time_rounds(steps: Dict[str, Callable], iters: int, rounds: int,
                dev: torch.device):
    """Each step's per-step milliseconds in each of ``rounds`` rounds, the
    steps in turns within a round, and the host's milliseconds a step to
    launch them (two dicts of lists, keyed as ``steps``)."""
    per: Dict[str, List[float]] = {name: [] for name in steps}
    launch: Dict[str, List[float]] = {name: [] for name in steps}
    for _ in range(rounds):
        for name, step in steps.items():
            ms, host = _steps_ms(step, iters, dev)
            per[name].append(ms)
            launch[name].append(host)
    return per, launch


def graph_ms(step: Callable, reps: int) -> float:
    """Device milliseconds of one step: the step captured as a CUDA graph
    and replayed ``reps`` times between two CUDA events.  The capture
    fails if the step waits on the device from the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's power limit in watts from ``nvidia-smi``, or None (and a
    line on stderr saying why) when it cannot be read."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        print(f"bench: power limit not read ({e!r}); power_limit_w is null",
              file=sys.stderr)
        return None


def _stage_lines(pipe, i16: np.ndarray, n: int, iters: int, rounds: int,
                 dev: torch.device) -> None:
    """The coarse split of the step (the channelizer kernel's flat streams,
    the noise floor, the PDW tail), each timed with the step's protocol on
    the dense capture's float planes; one stderr line a stage."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as kernels
    from sdr_channelizer_tpu_torch.ops import medians

    taps = pipe.channelizer.taps_rev
    sr, si = _planes(i16, dev)
    mag, ph, sat = kernels.channelize_streams(sr, si, taps)
    nf = medians.median(mag, dim=0)
    stages = {
        "streams_kernel": lambda: kernels.channelize_streams(sr, si, taps),
        "noise_floor": lambda: medians.median(mag, dim=0),
        "pdw_extract": lambda: pdwmod.extract_pdws_channelized_streams(
            mag, ph, sat > 0.5, pipe.pdw_cfg, noise_floor=nf),
    }
    for step in stages.values():
        step()
    for name, per in time_rounds(stages, iters, rounds, dev)[0].items():
        ms = statistics.median(per)
        print(f"bench: {name:<14s} {n / ms / 1e3:10.1f} Msps  "
              f"({ms:.2f} ms)", file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    from sdr_channelizer_tpu_torch._device import resolve_device
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models.pipeline import ChannelizerPipeline

    ap = argparse.ArgumentParser(
        prog="sdr_channelizer_tpu_torch.bench",
        description="channelize -> noise floor -> PDW throughput on one card")
    ap.add_argument("--bands", type=int, default=64)
    ap.add_argument("--frames", type=int, default=262144,
                    help="channelizer frames per step (samples = "
                         "frames * bands)")
    ap.add_argument("--iters", type=int, default=120,
                    help="consecutive steps between two CUDA events (K)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of K steps, dense and sparse in turns (R)")
    ap.add_argument("--stages", action="store_true",
                    help="also time the streams kernel, the noise floor and "
                         "the PDW tail separately")
    ap.add_argument("--planes", action="store_true",
                    help="time the float32-planes ingest instead of the "
                         "packed int16 headline")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device (an error "
                         "when there is none)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu: the kernels' plain "
                         "versions on the host, timed by the host clock")
    args = ap.parse_args(argv)
    if args.iters < 1 or args.rounds < 1:
        ap.error("--iters and --rounds must be at least 1")
    dev = resolve_device("cpu" if args.cpu else args.device)
    name = (f"cuda:{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
            else "cpu")
    print(f"bench: device = {name}", file=sys.stderr)

    n = args.bands * args.frames
    pipe = ChannelizerPipeline.create(
        args.bands, device=dev,
        pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024))
    i16 = {"dense": quantize(make_capture(n, args.bands)),
           "sparse": quantize(make_capture(n, args.bands, sparse=True))}
    if args.planes:
        ingest = "f32_planes"
        payload = {k: _planes(v, dev) for k, v in i16.items()}

        def forward(key):
            return pipe.forward_fused(*payload[key], bit_width=0)
    else:
        # the recorder's int16 I/Q pairs viewed as one int32 plane:
        # deinterleave and Q11 dequantization happen in the kernel
        ingest = "packed_int16"
        payload = {k: torch.as_tensor(
            np.ascontiguousarray(v).view(np.int32).ravel(), device=dev)
            for k, v in i16.items()}

        def forward(key):
            return pipe.forward_packed(payload[key], bit_width=12)

    if args.stages:
        _stage_lines(pipe, i16["dense"], n, args.iters, args.rounds, dev)

    t0 = time.perf_counter()
    pulses = {}
    for key in payload:
        for _ in range(WARMUP_STEPS):
            pulses[key] = int(forward(key)[2].count.sum())
    print(f"bench: warm-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    per, launch = time_rounds(
        {key: (lambda key=key: forward(key)) for key in payload},
        args.iters, args.rounds, dev)
    dense_ms = statistics.median(per["dense"])
    sparse_ms = statistics.median(per["sparse"])
    spread = (max(per["dense"]) - min(per["dense"])) / dense_ms * 100.0
    device_step_ms = (graph_ms(lambda: forward("dense"), args.iters)
                      if dev.type == "cuda" else None)
    msps = n / dense_ms / 1e3
    print(f"bench: dense  {dense_ms:.4f} ms/step ({pulses['dense']} pulses), "
          f"device {device_step_ms} ms, rep spread {spread:.2f}%",
          file=sys.stderr)
    print(f"bench: host launches a dense step in "
          f"{statistics.median(launch['dense']):.4f} ms (rounds "
          f"{', '.join(f'{x:.4f}' for x in launch['dense'])}; events "
          f"{', '.join(f'{x:.4f}' for x in per['dense'])})", file=sys.stderr)
    print(f"bench: sparse {sparse_ms:.4f} ms/step ({pulses['sparse']} "
          f"pulses)", file=sys.stderr)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(json.dumps({
        "metric": "channelize_pdw_throughput",
        "value": msps,
        "unit": "Msamples/s/card",
        "vs_baseline": msps / BASELINE_MSPS,
        "latency_p50_ms": dense_ms,
        "dense_pulses_per_step": pulses["dense"],
        "sparse_msps": n / sparse_ms / 1e3,
        "sparse_pulses_per_step": pulses["sparse"],
        "protocol": f"{clock} around K={args.iters} consecutive steps, "
                    f"median of R={args.rounds} rounds, dense and sparse "
                    f"in turns",
        "rep_spread_pct": spread,
        "ingest": ingest,
        "device": name,
        "device_step_ms": device_step_ms,
        "power_limit_w": power_limit_w(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
