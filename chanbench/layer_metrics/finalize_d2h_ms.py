"""``finalize_pdws``'s seven transfers of the batch to the host, a
capture: the self time of the span ``finalize.d2h``."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "finalize.d2h")
