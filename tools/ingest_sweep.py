"""Time ``io.iqpacket.to_complex`` on this host: the module's threshold and pool
against one pass on the caller's thread, pools of other sizes, and the
two strided passes it replaced, on int16 captures held in memory and on
fresh maps of ``.iq`` files (``read_iq``, a new map a call; the file's
pages are in the page cache, so a read is warm).

    python -m tools.ingest_sweep [--reps 15] [--out ingest_sweep.json]

from the root of a checkout.

Each form runs ``--reps`` calls back to back after one to warm up,
the forms in turn forwards and then backwards; each result is checked bit for bit
against the strided form.  Prints one line a (source, rows, form): the
median and the 90th percentile in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np

from sdr_channelizer_tpu_torch.io import iqpacket

ROWS = (1 << 16, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 16_000_000)
BIT_WIDTH = 12


def strided(samples, bit_width):
    """The form ``to_complex`` had before its one pass."""
    scale = np.float32(1.0 / 2 ** (bit_width - 1))
    out = np.empty(samples.shape[0], dtype=np.complex64)
    out.real = samples[:, 0].astype(np.float32) * scale
    out.imag = samples[:, 1].astype(np.float32) * scale
    return out


pools: dict = {}      # a pool of each size, kept across calls


def pooled(workers: int, min_bytes: int):
    """``to_complex`` with a pool of ``workers`` from ``min_bytes`` on."""
    def run(samples, bit_width):
        saved = (iqpacket.TO_COMPLEX_MAX_WORKERS,
                 iqpacket.TO_COMPLEX_PARALLEL_MIN_BYTES, iqpacket._pool)
        iqpacket.TO_COMPLEX_MAX_WORKERS = workers
        iqpacket.TO_COMPLEX_PARALLEL_MIN_BYTES = min_bytes
        iqpacket._pool = pools.setdefault(workers, None)
        try:
            return iqpacket.to_complex(samples, bit_width)
        finally:
            pools[workers] = iqpacket._pool
            (iqpacket.TO_COMPLEX_MAX_WORKERS,
             iqpacket.TO_COMPLEX_PARALLEL_MIN_BYTES, iqpacket._pool) = saved
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cores = len(os.sched_getaffinity(0))
    forms = {"strided": strided, "default": iqpacket.to_complex,
             "one_thread": pooled(1, 1 << 62)}
    for k in (2, 4, 6, 8, 12, 16):
        if k <= cores:
            forms[f"pool{k}"] = pooled(k, 0)
    rng = np.random.default_rng(2024)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for rows in ROWS:
            payload = rng.integers(-2048, 2048, size=(rows, 2),
                                   dtype=np.int16)
            path = os.path.join(tmp, f"cap{rows}.iq")
            hdr = iqpacket.IqHeader(frequency_hz=1e9, bandwidth_hz=56e6,
                                    sample_rate_sps=56e6, rx_gain_db=0,
                                    num_samples=rows, bit_width=BIT_WIDTH,
                                    sample_start_time=0.0)
            iqpacket.write_iq(path, hdr, payload)
            want = strided(payload, BIT_WIDTH).view(np.uint32)
            sources = {"memory": lambda: payload,
                       "fresh_map": lambda: iqpacket.read_iq(path)[1]}
            times = {(s, f): [] for s in sources for f in forms}
            # a form's calls run back to back, as a caller's captures do
            # (allocation reuse differs when other forms come between);
            # the forms go forwards, then backwards, against drift
            order = list(forms)
            for rnd in range(2):
                for s, src in sources.items():
                    for f in order:
                        for rep in range(args.reps + 1):
                            x = src()
                            t0 = time.perf_counter()
                            got = forms[f](x, BIT_WIDTH)
                            dt = time.perf_counter() - t0
                            if not np.array_equal(got.view(np.uint32), want):
                                raise SystemExit(f"bits differ: {s} {rows} {f}")
                            if rep:      # the first call warms up
                                times[(s, f)].append(dt * 1e3)
                            del got, x
                order.reverse()
            for (s, f), ts in times.items():
                q = statistics.quantiles(ts, n=10)
                row = {"source": s, "rows": rows, "form": f,
                       "p50_ms": statistics.median(ts), "p90_ms": q[-1]}
                results.append(row)
                print(f"{s:9s} {rows:9d} {f:10s} p50 {row['p50_ms']:9.3f} "
                      f"p90 {row['p90_ms']:9.3f}", flush=True)
            os.remove(path)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cores": cores, "reps": args.reps,
                       "threshold_bytes": iqpacket.TO_COMPLEX_PARALLEL_MIN_BYTES,
                       "max_workers": iqpacket.TO_COMPLEX_MAX_WORKERS,
                       "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
