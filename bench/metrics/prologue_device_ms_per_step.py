"""Device milliseconds a step that the program launched inside its
``stencil.prologue`` spans, once a call and spread over the call's steps:
scalars, coefficient pads and the carries built from the caller's fields
(bench/spans.py)."""

from bench import spans


def read(run):
    return spans.device_ms_per_step(run, "stencil.prologue")
