"""``analysis_p90_s``: the 90th percentile (linear rule) of every analysis's
host wall, from the call until its statistics are on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.walls, 90)) if run.walls else None
