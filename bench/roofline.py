"""The least time one call can take on an NVIDIA H100 SXM, from the work
the configuration states, whatever implements it.

A call advances ``steps`` steps over the whole grid. Its bytes: each field
it reads is read once and each field its update changes is written once,
at every point, plus each per-level coefficient once. Its operations: the
configuration's ``flops_per_point`` at every point, every step. The least
time is the larger of the bytes over the memory rate and the operations
over the float32 rate outside the tensor cores (NVIDIA's H100 SXM data
sheet, at the 700 W the rates assume). Temporal blocking, fused kernels or
graphs cannot take a call below it, so a share of it cannot pass 100%.

A cell over several cards divides the same bytes and operations over their
summed rates. The halo slabs that the cards exchange are left out: they are
work that the decomposition adds, not work that the configuration states,
so the least time stays a floor.
"""

from __future__ import annotations

import math

#: bytes/s of the H100 SXM's HBM3
HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP/s of the H100 SXM outside the tensor cores
PEAK_F32_FLOPS = 67e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def call_work(config: dict, grid, steps: int) -> tuple:
    """``(bytes, operations)`` one call of ``steps`` steps must move and
    do."""
    points = math.prod(int(g) for g in grid)
    size = ITEMSIZE[config["dtype"]]
    fields = len(config["reads"]) + len(config["writes"])
    coeff_elems = sum(int(grid[c["axis"]])
                      for c in config["inputs"]["coeffs"].values())
    nbytes = (fields * points + coeff_elems) * size
    ops = float(config["flops_per_point"]) * points * int(steps)
    return float(nbytes), ops


def least_time(config: dict, grid, steps: int, chips: int = 1) -> tuple:
    """``(seconds, "bytes" | "operations")``: the call's least time on
    ``chips`` cards and which of the two bounds it."""
    nbytes, ops = call_work(config, grid, steps)
    t_bytes = nbytes / (chips * HBM_BYTES_PER_S)
    t_ops = ops / (chips * PEAK_F32_FLOPS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
