"""Device milliseconds a step that the program launched inside its
``stencil.pad`` spans: inputs and temps padded for a kernel's window
(bench/spans.py)."""

from bench import spans


def read(run):
    return spans.device_ms_per_step(run, "stencil.pad")
