"""The whole step's share, in %, of its roofline: the least time a capture's
step could take (``roofline.least_seconds``: the payload read and the
batch written once at the HBM rate, or the channelizer's operations at the
float32 rate, whichever is longer) over the kernels' device time a
capture.  The same work whatever kernels do it, so the share survives
kernels being fused, split or renamed."""

from chanbench import roofline


def read(res):
    if res.trace is None:
        return None
    kernel_s = res.trace.seconds("kernel") / res.captures
    if kernel_s <= 0:
        return None
    least = roofline.least_seconds(res.cfg, res.samples_per_capture,
                                   res.batches_per_capture)
    return 100.0 * least / kernel_s
