"""The host's time launching the staged steps' graphs and cloning their
outputs, a capture: the self time of the spans ``staged.replay`` and
``staged.clone``."""

from chanbench import program_spans

install = program_spans.install


def read(res):
    return program_spans.self_ms(res, "staged.replay", "staged.clone")
