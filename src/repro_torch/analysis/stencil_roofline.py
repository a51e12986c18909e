"""Modeled H100 performance of stencil programs (the port of
``repro.analysis.stencil_roofline``), priced from
:data:`repro_torch.hw.H100`'s data-sheet rates:

    time = max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)
    MPt/s = 1e-6 / time_per_point

Operations are priced at the float32 rate whatever the storage dtype: the
generated kernels compute in float32.

bytes_per_point per backend role (:func:`model_program`):
  * ``cuda`` (dataflow) — each fuse-group input read once, each group
    output written once: the least the group's kernel can move, which is
    the bound ``PERF.md`` gives every stencil kernel (:func:`kernel_traffic`)
  * ``torch_fused`` — one read per distinct field per op, one write per op
  * ``torch_naive`` — one read per stencil access, one write per op

:func:`model_plan` prices one plan's own geometry.  Under the block
schedule that is the port's 2.5-D CTA (``schedule.BlockCTA.traffic``: the
bytes its chunks stage and the operations they generate, halo planes,
warm-up and ragged tiles included), the count ``schedule.pick_block``
ranks tiles by.  Under the stream schedule it is the reference's count
over the legalised graph (chained halos, charged once per ``time_tile``).
The reference's fixed cost per sweep step, which rewarded a wider
``plane_tile``, has no counterpart: on the card a wider step was slower,
so the tuner's measurement ranks ``plane_tile``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import hw
from ..core.ir import Program, count_flops
from ..core.passes import infer_halo, live_ops, stage_split
from ..core.schedule import clamp_block, plan_block_cta


@dataclasses.dataclass
class StencilModel:
    flops_per_point: float
    bytes_per_point: dict      # backend -> bytes
    mpts_chip: dict            # backend -> modeled MPt/s on one card

    def mpts(self, backend: str, chips: int = 1) -> float:
        return self.mpts_chip[backend] * chips


def roofline_seconds(bytes_moved: float, flops: float) -> tuple:
    """``(seconds, what bounds them)``: ``bytes_moved`` over the H100's
    memory rate against ``flops`` over its float32 peak; ``"bytes"`` or
    ``"operations"``."""
    t_bytes = bytes_moved / hw.H100.hbm_bandwidth
    t_ops = flops / hw.H100.peak_f32_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_traffic(p: Program, grid: Sequence[int], inputs, outputs, exprs,
                   itemsize: int, coeffs=(), times: int = 1) -> tuple:
    """``(bytes, operations)`` the least a kernel over ``grid`` must move
    and do: each of ``inputs`` read once and each of ``outputs`` written
    once at every point, each coefficient of ``coeffs`` read once, and
    every expression of ``exprs`` evaluated once a point, ``times`` times
    (the steps one chained sweep advances)."""
    grid = [int(g) for g in grid]
    pts = float(np.prod(grid))
    elems = (len(inputs) + len(outputs)) * pts
    elems += sum(grid[p.coeffs[c]] for c in coeffs)
    flops = pts * int(times) * sum(count_flops(e) for e in exprs)
    return elems * itemsize, flops


def model_program(p: Program, dtype_bytes: int = 4) -> StencilModel:
    fl = p.flops_per_point()
    alive = live_ops(p)
    one = (1,) * p.ndim

    # dataflow: per group, each external input read once + outputs written
    dataflow_b = 0.0
    for g in stage_split(p, "auto"):
        gh = infer_halo(p, g)
        dataflow_b += kernel_traffic(p, one, gh.group_inputs,
                                     gh.group_outputs, (), dtype_bytes)[0]

    # naive: one read per access, one write per op
    accesses = sum(len(p.ops[i].accesses()) for i in alive)
    naive_b = (accesses + len(alive)) * dtype_bytes

    # fused torch: one read per distinct field per op + one write per op
    fused_reads = sum(len({a.field for a in p.ops[i].accesses()})
                      for i in alive)
    fused_b = (fused_reads + len(alive)) * dtype_bytes

    bytes_pp = {"cuda": dataflow_b, "torch_fused": fused_b,
                "torch_naive": naive_b}
    mpts = {k: 1e-6 / roofline_seconds(b, fl)[0]
            for k, b in bytes_pp.items()}
    return StencilModel(flops_per_point=fl, bytes_per_point=bytes_pp,
                        mpts_chip=mpts)


def _block_traffic(p: Program, plan, grid) -> tuple:
    """(bytes, operations) per grid point of a block plan's kernels: each
    group's CTA staging its input planes and generating its operations
    (``BlockCTA.traffic``), and writing each group output once."""
    bs = hw.DTYPE_BYTES[plan.dtype]
    blk = clamp_block(plan.block[:p.ndim], grid)
    bytes_pp = flops_pp = 0.0
    for grp in plan.groups:
        staged, ops = plan_block_cta(p, grp, blk, plan.dtype).traffic(grid)
        bytes_pp += staged + len(infer_halo(p, grp).group_outputs) * bs
        flops_pp += ops
    return bytes_pp, flops_pp


def _stream_graph(p: Program, plan, grid, graph):
    if graph is None:
        from ..core.dataflow import lower_to_dataflow
        graph = lower_to_dataflow(p, plan, grid)
    return graph


def plan_bytes_per_point(p: Program, plan, grid, graph=None) -> float:
    """Modeled device-memory bytes per grid point for one plan's geometry.

    * ``"block"`` — the port's CTA: each chunk stages its input planes once
      (halo rows, halo planes and ragged tiles included), outputs are
      written once (:func:`_block_traffic`).
    * ``"stream"`` — the reference's count: each input cell fetched once
      per region sweep, inflated by the padded halo ring
      ``prod(padded extents) / prod(grid)``; with an effective
      ``time_tile = T > 1`` the sweep's traffic (inputs through the
      chained halo, outputs written once) is charged once per T steps.

    The torch backends ignore plan geometry and collapse to
    :func:`model_program`'s role numbers.
    """
    bs = hw.DTYPE_BYTES[plan.dtype]
    if plan.backend != "cuda":
        return float(model_program(p, dtype_bytes=bs)
                     .bytes_per_point[plan.backend])
    grid = [int(g) for g in grid]
    if getattr(plan, "schedule", "block") != "stream":
        return _block_traffic(p, plan, grid)[0]
    graph = _stream_graph(p, plan, grid, graph)
    T = max(1, int(getattr(graph, "time_tile", 1)))
    bytes_pp = 0.0
    for gh in graph.group_halos():
        padded = [grid[a] + int(gh.input_halo[a, 0])
                  + int(gh.input_halo[a, 1]) for a in range(p.ndim)]
        overhead = float(np.prod(padded)) / float(np.prod(grid))
        bytes_pp += (len(gh.group_inputs) * overhead * bs
                     + len(gh.group_outputs) * bs) / T
    return bytes_pp


def _stream_flops_per_point(p: Program, grid, graph) -> float:
    """Recompute-inflated operations per point of a sweep (the
    reference's count): margins widen only the non-stream axes of each
    plane; a chain runs every op once per stage, earlier stages over
    planes widened by ``(T-1-s)`` per-step halo reaches, amortised over
    the T steps one sweep advances."""
    T = max(1, int(getattr(graph, "time_tile", 1)))
    flops_pp = 0.0
    plane = np.asarray(grid[1:], dtype=np.int64)
    for region in graph.regions:
        ih = region.halo.input_halo          # per-step reach
        step = ih[1:, 0] + ih[1:, 1]
        for s in range(T):
            acc = T - 1 - s
            for i in region.ops:
                m = region.halo.margins[i]
                ext = plane + m[1:, 0] + m[1:, 1] + acc * step
                recompute = float(np.prod(ext)) / float(np.prod(plane))
                flops_pp += count_flops(p.ops[i].expr) * recompute / T
    return flops_pp


def model_plan(p: Program, plan, grid) -> float:
    """Modeled seconds per time step of one plan (the tuner's pruner):
    :func:`plan_bytes_per_point` and the plan's operations a point priced
    by :func:`roofline_seconds`.  The torch backends collapse to
    :func:`model_program`'s role numbers.

    :mod:`repro_torch.obs.achieved` holds the prediction against the card:
    ``achieved_fraction = model_plan(...) * steps / measured_seconds``."""
    grid = [int(g) for g in grid]
    pts = float(np.prod(grid))
    bs = hw.DTYPE_BYTES[plan.dtype]
    if plan.backend != "cuda":
        m = model_program(p, dtype_bytes=bs)
        return pts / (m.mpts(plan.backend) * 1e6)
    if getattr(plan, "schedule", "block") == "stream":
        graph = _stream_graph(p, plan, grid, None)
        bytes_pp = plan_bytes_per_point(p, plan, grid, graph=graph)
        flops_pp = _stream_flops_per_point(p, grid, graph)
    else:
        bytes_pp, flops_pp = _block_traffic(p, plan, grid)
    return roofline_seconds(bytes_pp * pts, flops_pp * pts)[0]


def modeled_energy_j(points: float, mpts: float,
                     watts: float = hw.H100.power_watts) -> float:
    """Energy = execution time x the card's power limit."""
    seconds = points / (mpts * 1e6)
    return seconds * watts
