"""The call's least time on the cell's cards (bench/roofline.py) over the
device time of the generated kernels in one call on the mean card, in
percent."""


def read(run):
    tr = run.trace
    if not tr or not tr["generated_ops"] or tr["generated_s"] <= 0:
        return None
    return 100.0 * run.least_time_s / (tr["generated_s"] / tr["calls"])
