"""Gigabytes a step of the buffers that the pads filling wraparound slabs
make: the program's ``stencil.wrap_bytes`` over its ``stencil.steps``,
every call of the run's process counted (bench/spans.py). Nothing where
the program keeps no such counter or counted nothing in it."""

from bench import spans


def read(run):
    c = spans.counters()
    if c is None or not c.get("wrap_bytes"):
        return None
    return c["wrap_bytes"] / c["steps"] / 1e9
