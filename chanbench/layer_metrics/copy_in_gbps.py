"""The staged steps' copy-in rate, GB/s: the bytes copied from the host
into the graphs' inputs (the counter ``staged.copy_in_bytes``: the dwell's
payload, the streamed path's block uploads) over the host's time in the
copies (the span ``staged.copy_in``, which holds the host until a pageable
copy has landed)."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    snap = program_spans.recorded()
    if snap is None:
        return None
    n_bytes = snap["counters"].get("staged.copy_in_bytes", 0)
    seconds = snap["spans"].get("staged.copy_in", {}).get("total_s", 0.0)
    if n_bytes <= 0 or seconds <= 0:
        return None
    return n_bytes / seconds * 1e-9
