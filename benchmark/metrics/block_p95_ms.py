"""End to end, stream cells: the 95th percentile (NumPy's) over all
blocks of the window of one block's latency, ms: the call to the end of
the synchronise after it, on the host's clock."""

import numpy as np


def read(run):
    lat = run.window.latency_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
