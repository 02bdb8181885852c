"""The streamed path's exact floor, a capture (a segment), less its reads,
copy-ins and replays: the self time of the span ``stream.floor`` (the
count levels' waits and fetches, the host's nibble work)."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "stream.floor")
