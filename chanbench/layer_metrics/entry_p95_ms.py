"""95th percentile, over every capture of the traced window, of the host
time from the call into the entry to its host PDW dict: the cell's tail
where the host's drift from run to run is too wide for an end-to-end
bound."""

import numpy as np


def read(res):
    if not res.latencies_s:
        return None
    return float(np.percentile(res.latencies_s, 95)) * 1e3
