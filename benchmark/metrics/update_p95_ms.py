"""The 95th percentile, in ms, over every integrated update of the window,
each timed on the host from the scan's hand-over to its pose read on the
host: the latency of a published pose."""

import numpy as np


def measure(run):
    return float(np.percentile(np.asarray(run.latency_s) * 1e3, 95))
