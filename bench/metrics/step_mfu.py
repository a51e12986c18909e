"""The whole call's share of the chip's peak: the call's least time
(bench/roofline.py) over the median wall time of the window's calls, in
percent."""

import statistics


def read(run):
    return 100.0 * run.least_time_s / statistics.median(run.call_s)
