"""The least time of a step's wraparound slabs (bench/wrap.py) over the
device time a step launched inside the program's ``stencil.wrap`` spans,
in percent. Nothing where the stretch holds no such span, or where the run
is not at its configuration's grid (the least time is the grid's)."""

import math

from bench import spans, wrap

SPAN = "stencil.wrap"


def read(run):
    att = spans.of_run(run)
    if att is None or SPAN not in att["by_span"]:
        return None
    cfg = run.cell.config
    if math.prod(cfg["grid"]) != run.points:
        return None
    ms = spans.device_ms_per_step(run, SPAN)
    if not ms:
        return None
    return 100.0 * wrap.least_time(cfg, cfg["grid"]) / (ms / 1e3)
