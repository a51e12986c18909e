"""Device milliseconds a step that the program launched inside its
``stencil.update`` spans: the fused loop's update rule on the host's
tensors (bench/spans.py)."""

from bench import spans


def read(run):
    return spans.device_ms_per_step(run, "stencil.update")
