"""The share of the bytes ``io.iqpacket.to_complex`` wrote that its thread
pool wrote, %: the counter ``ingest.to_complex_parallel_bytes`` over
``ingest.to_complex_bytes``.  A program that keeps no such counter gives
nothing to read."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    snap = program_spans.recorded()
    if snap is None:
        return None
    counters = snap["counters"]
    n_bytes = counters.get("ingest.to_complex_bytes", 0)
    if n_bytes <= 0:
        return None
    return counters.get("ingest.to_complex_parallel_bytes", 0) / n_bytes * 100
