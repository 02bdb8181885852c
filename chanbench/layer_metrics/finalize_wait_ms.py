"""``finalize_pdws``'s wait for the step ahead of its transfers, a capture:
the self time of the span ``finalize.wait`` (a batch on the card)."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "finalize.wait")
