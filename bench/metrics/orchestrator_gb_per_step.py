"""Gigabytes a step of new buffers the orchestrator makes and carry it
writes: the program's ``stencil.pad_bytes`` plus ``stencil.carry_bytes``
over its ``stencil.steps``, every call of the run's process counted
(bench/spans.py)."""

from bench import spans


def read(run):
    c = spans.counters()
    if c is None:
        return None
    return (c["pad_bytes"] + c["carry_bytes"]) / c["steps"] / 1e9
