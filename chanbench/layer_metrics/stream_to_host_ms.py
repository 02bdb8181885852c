"""The streamed path's block batches brought to the host, a capture (a
segment): the self time of the span ``stream.to_host``, the wait for each
block's step included."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "stream.to_host")
