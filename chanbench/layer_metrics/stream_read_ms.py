"""The streamed path's block reads from the files, a capture (a segment):
the self time of the span ``stream.read``."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "stream.read")
