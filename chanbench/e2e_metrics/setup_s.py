"""Process start to the first timed capture: imports, the CUDA context,
the kernels' build or load, the pool made from the seed, the entry built
and warmed up on every item."""


def read(res):
    return res.setup_s
