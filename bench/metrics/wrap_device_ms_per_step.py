"""Device milliseconds a step that the program launched inside its
``stencil.wrap`` spans: the pads that fill the wraparound slabs of a field
periodic on some axis, in the prologue, a pad or the write-back
(bench/spans.py). Nothing where the stretch holds no such span."""

from bench import spans

SPAN = "stencil.wrap"


def read(run):
    att = spans.of_run(run)
    if att is None or SPAN not in att["by_span"]:
        return None
    return spans.device_ms_per_step(run, SPAN)
