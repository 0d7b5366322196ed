"""latency_p95_ms: the 95th percentile of every call of the window, each
timed from its start until its answers are on the host."""
import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
