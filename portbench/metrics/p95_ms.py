"""The 95th percentile of every query's latency in the window (ms). A
query's latency is its batch's wall time, request compilation included,
up to its results on the host."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    per_query = np.repeat(np.asarray(run.latencies), run.batch)
    return float(np.percentile(per_query, 95)) * 1e3
