"""Device milliseconds a step that the program launched inside its
``stencil.write_back`` spans: the loop carry rebuilt or written in place
(bench/spans.py)."""

from bench import spans


def read(run):
    return spans.device_ms_per_step(run, "stencil.write_back")
