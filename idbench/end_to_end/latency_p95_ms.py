"""The 95th percentile of every call's latency in the window, host clock
from the call to the synchronisation that ends it (linear interpolation
between order statistics, numpy's default)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
