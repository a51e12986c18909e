"""The least time of a step's wraparound slabs on an NVIDIA H100 SXM, from
the configuration alone, whatever fills them.

A field the update changes goes stale in its halo each step wherever its
boundary wraps. The slabs that must be refreshed then are, for each field
the configuration writes and each axis along which its ``boundary`` is
periodic, one plane of the grid on either side (the Piacsek-Williams
scheme reads one point along each axis), each read once and written once.
Their bytes over the memory rate are the least time; a refresh that
rebuilds the whole padded buffer moves far more and reads far under it.
"""

from __future__ import annotations

import math

from .roofline import HBM_BYTES_PER_S, ITEMSIZE

#: planes of halo on either side of a periodic axis: pw's reach
REACH = 1


def periodic_axes(config: dict) -> list:
    """The grid axes along which the configuration's boundary wraps."""
    b = config["boundary"]
    kinds = [b] * len(config["grid"]) if isinstance(b, str) else list(b)
    return [a for a, k in enumerate(kinds) if k == "periodic"]


def slab_bytes(config: dict, grid) -> float:
    """Bytes a step of the written fields' wraparound slabs, read once and
    written once."""
    grid = [int(g) for g in grid]
    points = math.prod(grid)
    plane = sum(points // grid[a] for a in periodic_axes(config))
    return float(len(config["writes"]) * 2 * REACH * plane * 2
                 * ITEMSIZE[config["dtype"]])


def least_time(config: dict, grid) -> float:
    """Seconds a step the slabs take at the card's memory rate."""
    return slab_bytes(config, grid) / HBM_BYTES_PER_S
