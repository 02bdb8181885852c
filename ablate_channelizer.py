#!/usr/bin/env python3
"""Where the time of the port's channelizer body goes, by ablation.

    python3 ablate_channelizer.py [--rounds 5] [--loop 20]

Runs on one NVIDIA GPU, from the repo root.  ``ncu`` does not run on the
measuring machine, so the phases of the body in
``sdr_channelizer_tpu_torch/ops/cuda/csrc/channelizer.cu`` (ingest and
dequant, the branch FIR, the DFT, the epilogue's arithmetic, the epilogue's
writes) are timed by taking them out one at a time: the script copies the
source into the build directory, rewrites a few of its lines so that
compile-time macros can cut each phase down (the DFT to one k-step, the FIR
to one tap, ``sqrtf`` and ``atan2`` to an add, the ingest's global loads
and the global writes behind a condition that is false at run time but
unknown to the compiler), builds one library per variant, all at once, and
times each through the package's wrapper at K1's main shape (cm2 form, M =
64 x 262144 frames of the benchmark's dense capture, packed int16)
and at B6's streamed block shape (cm form, 65536 + 1024 frames with the
history of the block before).  A reading is CUDA events around ``--loop``
calls in a row, over the calls, so that the wrapper's host time hides
behind the kernels; the variants take turns, ``--rounds`` times, and a
phase is the full body less the variant without it, in the same round.  A
rewrite whose line is no longer in the source stops the script.  The
kernel in the package carries no such switch.  One JSON line a shape:
each variant's and each phase's median, least and most over the rounds,
the card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "sdr_channelizer_tpu_torch", "ops", "cuda",
                      "csrc", "channelizer.cu")

# macro -> (old text, new text); every old text must occur in the source
REWRITES = {
    "ABL_DFT": [("for (int ks = 0; ks < nks; ++ks) {",
                 "for (int ks = 0; ks < (ABL_DFT ? 1 : nks); ++ks) {")],
    "ABL_FIR": [("for (int p = 0; p < P; ++p) {",
                 "for (int p = 0; p < (ABL_FIR ? 1 : P); ++p) {")],
    "ABL_EPI": [("mag_s[kl * PS + t] = sqrtf(re * re + im * im);",
                 "mag_s[kl * PS + t] = ABL_EPI ? re + im : "
                 "sqrtf(re * re + im * im);"),
                ("ph_s[kl * PS + t] = atan2_cephes(im, re) * rad2deg;",
                 "ph_s[kl * PS + t] = ABL_EPI ? re - im : "
                 "atan2_cephes(im, re) * rad2deg;")],
    "ABL_WRITE": [("if (kMode != kCm2) {",
                   "if (kMode != kCm2 && (!ABL_WRITE || scale < 0.0f)) {"),
                  ("            if (live) {\n              mag_cm[row + ta]",
                   "            if (live && (!ABL_WRITE || scale < 0.0f)) {"
                   "\n              mag_cm[row + ta]")],
    "ABL_INGEST": [("              in.load4(g, vi[j], vq[j]);",
                    "              if (!ABL_INGEST || scale < 0.0f) "
                    "in.load4(g, vi[j], vq[j]);\n"
                    "              else for (int e = 0; e < 4; ++e) "
                    "vi[j][e] = vq[j][e] = (float)((g + e) & 7);")],
}

VARIANTS = {
    "full": [],
    "no_dft": ["ABL_DFT"],
    "no_fir": ["ABL_FIR"],
    "no_epilogue_math": ["ABL_EPI"],
    "no_writes": ["ABL_WRITE"],
    "no_ingest_reads": ["ABL_INGEST"],
    "ingest_only": ["ABL_DFT", "ABL_FIR", "ABL_EPI", "ABL_WRITE"],
}

# phase -> the variant without it (ingest_and_rest: what is left with the
# other four cut)
PHASES = {"dft": "no_dft", "fir": "no_fir",
          "epilogue_math": "no_epilogue_math", "epilogue_writes": "no_writes",
          "ingest_reads": "no_ingest_reads", "ingest_and_rest": "ingest_only"}


def rewrite(src: str) -> str:
    head = "".join(f"#ifndef {m}\n#define {m} 0\n#endif\n" for m in REWRITES)
    for macro, pairs in REWRITES.items():
        for old, new in pairs:
            if old not in src:
                raise SystemExit(f"{macro}: line not found in the source: "
                                 f"{old!r}")
            src = src.replace(old, new)
    return head + src


def build(build_dir: str) -> dict:
    """One library per variant, ``nvcc`` started for all of them at once."""
    import ctypes

    from sdr_channelizer_tpu_torch.ops.cuda import _build

    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, "ablate_channelizer.cu")
    with open(SOURCE) as f:
        text = rewrite(f.read())
    with open(path, "w") as f:
        f.write(text)
    procs = {}
    for name, macros in VARIANTS.items():
        out = os.path.join(build_dir, f"libablate_{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
               *[f"-D{m}=1" for m in macros], "-o", out, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def loop_ms(fn, loop: int) -> float:
    """ms a call: CUDA events around ``loop`` calls in a row."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(loop):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / loop


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--loop", type=int, default=20)
    ap.add_argument("--build-dir", default=os.path.join(
        ROOT, "sdr_channelizer_tpu_torch", "ops", "cuda", "build", "ablate"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ablate_channelizer: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch_card_fixtures as cs
    from sdr_channelizer_tpu_torch import bench
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops.cuda import _build
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    libs = build(args.build_dir)
    dev = torch.device("cuda")
    m = cs.M_MAIN
    taps_np = Channelizer.create(m).taps_rev.astype(np.float32)
    p = taps_np.shape[0]
    xq = torch.as_tensor(
        cs.pack(bench.quantize(bench.make_capture(m * cs.FRAMES_MAIN, m))),
        device=dev)
    f0, blk_len = cs.BLOCK_FRAMES, cs.BLOCK_FRAMES + cs.HALO_FRAMES
    shapes = {
        f"K1 cm2, M={m} T={cs.FRAMES_MAIN}": (
            ck.channelize_streams_packed_cm2, xq, None),
        f"B6 cm, M={m} T={blk_len} (streamed block)": (
            ck.channelize_streams_packed_cm, xq[f0 * m:(f0 + blk_len) * m],
            xq[(f0 - (p - 1)) * m:f0 * m]),
    }
    built = _build.load("channelizer")
    try:
        for label, (fn, x, hist) in shapes.items():
            def call():
                fn(x, taps_np, cs.BIT_WIDTH, 0.9999, history=hist)

            ms = {name: [] for name in libs}
            for name, lib in libs.items():      # warm-up: typing, weights
                _build._libs["channelizer"] = lib
                loop_ms(call, 2)
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    _build._libs["channelizer"] = lib
                    ms[name].append(loop_ms(call, args.loop))
            phases = {
                ph: spread([v if ph == "ingest_and_rest" else f - v
                            for f, v in zip(ms["full"], ms[name])])
                for ph, name in PHASES.items()}
            print(json.dumps({
                "shape": label, "card": card, "rounds": args.rounds,
                "loop": args.loop,
                "ms": {name: spread(v) for name, v in ms.items()},
                "phase_ms": phases}), flush=True)
    finally:
        _build._libs["channelizer"] = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
