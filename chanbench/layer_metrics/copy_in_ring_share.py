"""The share of the staged steps' host bytes that reached the graphs'
inputs through page-locked staging, %: the counter
``staged.copy_in_ring_bytes`` over ``staged.copy_in_bytes``.  A program
that keeps no such counter gives nothing to read."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    snap = program_spans.recorded()
    if snap is None:
        return None
    counters = snap["counters"]
    n_bytes = counters.get("staged.copy_in_bytes", 0)
    ring_bytes = counters.get("staged.copy_in_ring_bytes")
    if n_bytes <= 0 or ring_bytes is None:
        return None
    return ring_bytes / n_bytes * 100
