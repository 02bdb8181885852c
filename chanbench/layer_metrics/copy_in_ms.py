"""Host-to-device copies a capture, by the device trace: the staged step's
copy of the host payload into the graph's input, the streamed path's block
uploads."""


def read(res):
    if res.trace is None:
        return None
    s = res.trace.seconds("htod")
    return s / res.captures * 1e3 if s > 0 else None
