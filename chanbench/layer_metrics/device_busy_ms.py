"""Device time a capture: the union of the kernels', copies' and fills'
intervals in the traced window, over its captures."""


def read(res):
    if res.trace is None:
        return None
    return res.trace.busy_s() / res.captures * 1e3
