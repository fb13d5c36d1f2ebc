"""95th percentile of every window batch's time, from its submission to
its results on the host (host clock, the device synchronised)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms, 95)) \
        if run.latencies_ms else None
