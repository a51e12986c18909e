"""Transformation passes: stencil IR -> dataflow structure (paper §3.3).

The paper's nine FPGA transformations map here as:

  1. classify_args           -> :func:`classify`
  2. 512-bit packed interface-> lane alignment handled by the planner
                                (schedule.auto_plan picks 128-multiple blocks)
  3. streams                 -> fuse-group boundaries = materialised HBM
                                "streams"; inside a group the Pallas grid
                                pipeline is the stream
  4. per-field dataflow split-> :func:`stage_split` (one op per output field
                                is the IR normal form; grouping decides what
                                shares a window fetch)
  5. shift-buffer access map -> :func:`infer_halo` margins drive the window
                                slicing in the backends
  6. streamed write_data     -> Blocked output specs in the Pallas backend
  7. single load_data        -> shared input windows inside a fuse group
  8. small data -> BRAM      -> scalars lowered to SMEM/grid constants
  9. bundle per field        -> per-field PartitionSpec in core.distribute

:func:`infer_halo` also implements *overlapped tiling with recompute* for
in-group producer->consumer dependencies (tracer advection's structure): a
producer consumed at offset ``o`` by an op with margin ``(lo, hi)`` must be
evaluated on the extended region ``(lo - o, hi + o)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .ir import Expr, FieldRole, Program


# --------------------------------------------------------------------------
# 1. argument classification
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ArgClass:
    inputs: list       # external field inputs (read, never written)
    outputs: list      # stored results
    temps: list        # internal producer/consumer fields
    scalars: list      # runtime scalars ("small data")


def classify(p: Program) -> ArgClass:
    return ArgClass(inputs=p.input_fields(), outputs=p.output_fields(),
                    temps=p.temp_fields(), scalars=list(p.scalars))


# --------------------------------------------------------------------------
# Margins & halos (asymmetric, per axis)
# --------------------------------------------------------------------------

def _zeros(ndim: int) -> np.ndarray:
    return np.zeros((ndim, 2), dtype=np.int64)  # [:,0]=lo, [:,1]=hi


@dataclasses.dataclass
class GroupHalo:
    """Result of halo inference for one fuse group."""
    margins: dict          # op index -> (ndim,2) evaluation margin
    input_halo: np.ndarray  # (ndim,2) uniform window halo for group inputs
    group_inputs: list     # field names read from outside the group
    group_outputs: list    # field names leaving the group (stored or read later)
    internal: list         # fields produced & consumed strictly inside
    group_coeffs: list = dataclasses.field(default_factory=list)


def infer_halo(p: Program, group: Sequence[int]) -> GroupHalo:
    """Compute evaluation margins and window halo for a fuse group.

    ``group`` is a list of op indices (program order).  An op consumed by a
    later op *inside* the group is recomputed on an extended margin
    (overlapped tiling); fields consumed from *outside* the group are window
    inputs with halo.
    """
    group = list(group)
    gset = set(group)
    ndim = p.ndim
    producer = {p.ops[i].out: i for i in group}

    # which group fields escape (stored, or consumed by a later group)?
    consumed_later = set()
    for j, op in enumerate(p.ops):
        if j in gset:
            continue
        for a in op.accesses():
            consumed_later.add(a.field)
    group_outputs = []
    internal = []
    for i in group:
        out = p.ops[i].out
        role = p.fields[out].role
        if role == FieldRole.OUTPUT or out in consumed_later:
            group_outputs.append(out)
        else:
            internal.append(out)

    # margins: reverse order; consumers propagate need to producers
    margins = {i: _zeros(ndim) for i in group}
    for i in reversed(group):
        op = p.ops[i]
        m = margins[i]
        for a in op.accesses():
            if a.field in producer and producer[a.field] in gset:
                pi = producer[a.field]
                if pi >= i:
                    raise ValueError("dependency violates program order")
                need = _zeros(ndim)
                for ax in range(ndim):
                    o = a.offset[ax]
                    need[ax, 0] = max(0, m[ax, 0] - o)
                    need[ax, 1] = max(0, m[ax, 1] + o)
                margins[pi] = np.maximum(margins[pi], need)

    # window halo for external inputs = max over (margin + offset)
    halo = _zeros(ndim)
    group_inputs = []
    group_coeffs = []
    for i in group:
        op = p.ops[i]
        m = margins[i]
        for a in op.accesses():
            if a.field in producer:
                continue
            if a.field not in group_inputs:
                group_inputs.append(a.field)
            for ax in range(ndim):
                o = a.offset[ax]
                halo[ax, 0] = max(halo[ax, 0], m[ax, 0] - o)
                halo[ax, 1] = max(halo[ax, 1], m[ax, 1] + o)
        for c in op.coeff_refs():
            ax = p.coeffs[c.coeff]
            if c.coeff not in group_coeffs:
                group_coeffs.append(c.coeff)
            halo[ax, 0] = max(halo[ax, 0], m[ax, 0] - c.offset)
            halo[ax, 1] = max(halo[ax, 1], m[ax, 1] + c.offset)
    return GroupHalo(margins=margins, input_halo=halo,
                     group_inputs=group_inputs, group_outputs=group_outputs,
                     internal=internal, group_coeffs=group_coeffs)


def field_halo(p: Program) -> np.ndarray:
    """Whole-program max |offset| halo (used by the distributed executor)."""
    halo = _zeros(p.ndim)
    for op in p.ops:
        for a in op.accesses():
            for ax in range(p.ndim):
                o = a.offset[ax]
                halo[ax, 0] = max(halo[ax, 0], -o)
                halo[ax, 1] = max(halo[ax, 1], o)
    return halo


# --------------------------------------------------------------------------
# 4. stage splitting / fusion grouping
# --------------------------------------------------------------------------

#: Max recompute margin the ``auto`` strategy tolerates before cutting a fuse
#: group (≈ a halo-1 producer->consumer chain of depth 6).  Beyond this the
#: overlapped-tiling recompute volume grows faster than the HBM traffic a
#: larger group saves.
RECOMPUTE_MARGIN_CAP = 6

STAGE_SPLIT_STRATEGIES = ("fused", "per_field", "auto")

def live_ops(p: Program) -> list:
    """Dead-code elimination: op indices transitively feeding a stored output."""
    producer = {op.out: i for i, op in enumerate(p.ops)}
    live: set = set()
    work = [producer[f] for f in p.output_fields()]
    while work:
        i = work.pop()
        if i in live:
            continue
        live.add(i)
        for a in p.ops[i].accesses():
            j = producer.get(a.field)
            if j is not None and j not in live:
                work.append(j)
    return sorted(live)


def stage_split(p: Program, strategy: str = "auto") -> list:
    """Partition ops into ordered fuse groups.

    ``fused``     – one group containing every op (single kernel; shared
                    window fetch = the paper's single load_data stage, with
                    in-group recompute for dependencies).
    ``per_field`` – one group per op (the paper's literal per-field dataflow
                    split; intermediates stream through HBM).
    ``auto``      – fused, split only when recompute margins explode
                    (dependency chains deeper than ~3 halo widths).
    """
    alive = live_ops(p)
    if strategy == "per_field":
        return [[i] for i in alive]
    if strategy == "fused":
        return [alive]
    if strategy != "auto":
        raise ValueError(
            f"unknown stage_split strategy {strategy!r}; valid strategies: "
            + ", ".join(repr(s) for s in STAGE_SPLIT_STRATEGIES))
    # auto: greedily grow a group; cut when max margin exceeds threshold
    groups: list = []
    cur: list = []
    for i in alive:
        trial = cur + [i]
        gh = infer_halo(p, trial)
        worst = max((int(m.max()) for m in gh.margins.values()), default=0)
        if cur and worst > RECOMPUTE_MARGIN_CAP:
            groups.append(cur)
            cur = [i]
        else:
            cur = trial
    if cur:
        groups.append(cur)
    return groups


# --------------------------------------------------------------------------
# CSE statistics (Expr is hash-consed at lowering; this measures sharing)
# --------------------------------------------------------------------------

def cse_stats(p: Program) -> dict:
    seen: dict = {}

    def rec(e: Expr):
        seen[e] = seen.get(e, 0) + 1
        for c in e.children():
            rec(c)

    for op in p.ops:
        rec(op.expr)
    shared = sum(v - 1 for v in seen.values() if v > 1)
    return {"unique_nodes": len(seen), "reused_evals_saved": shared}
