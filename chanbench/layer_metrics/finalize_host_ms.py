"""``finalize_pdws``'s float64 formulas, selection and sort on the host, a
capture: the self time of the span ``finalize.host``."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "finalize.host")
