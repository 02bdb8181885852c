"""95th percentile, over every capture (or segment) of the window, of the
host time from the call into the entry to its host PDW dict."""

import numpy as np


def read(res):
    return float(np.percentile(res.latencies_s, 95)) * 1e3
