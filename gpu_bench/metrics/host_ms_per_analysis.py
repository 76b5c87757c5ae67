"""``host_ms_per_analysis``: the mean over the window's analyses of each
one's span less the union of device activity inside it (device trace)."""

import numpy as np


def read(run):
    if run.trace is None or not len(run.trace.spans):
        return None
    return float(np.mean(run.trace.host_s_per_span())) * 1e3
