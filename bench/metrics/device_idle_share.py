"""The share of the profiled stretch in which no device operation runs on
a card, for the mean card of the cell, in percent."""


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
