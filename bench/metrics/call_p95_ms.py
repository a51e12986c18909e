"""The nearest-rank 95th percentile of every window call's wall time, from
the host's call to the synchronise after it (host clock)."""

import math


def read(run):
    s = sorted(run.call_s)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)] * 1e3
