"""DataflowPlan — the HLS-dialect analogue, planned on Hopper terms (the
port of ``repro.core.schedule``, block schedule).

A plan is pure data: fuse groups (which ops share one kernel) and the
output tile ``block`` one CTA computes.  :func:`plan_to_dict` /
:func:`plan_from_dict` use the reference's serialised layout, so a plan
written by the JAX package reads back here unchanged (``StreamSpec`` is
carried as data only; the stream schedule is not lowered yet).

Where the reference prices a tile against a TPU VMEM budget with a
128-lane quantum, :func:`smem_cost` prices it against the shared memory one
CTA may use on an H100 (227 KB), and the contiguous axis is tiled in
multiples of a 32-thread warp for coalescing.  Fuse groups are exactly
``passes.stage_split``'s; only the tile differs from the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import itertools
from typing import Sequence

import numpy as np

from .. import hw
from .ir import Program
from .passes import _zeros, infer_halo, stage_split

SCHEDULES = ("block", "stream")

#: tile extents the planner tries: outer axes in powers of two, the
#: contiguous axis in one, two or four warps
OUTER_TILES = (1, 2, 4, 8, 16)
LANE_TILES = (32, 64, 128)

#: threads of a CTA: at most this many along the contiguous axis, and in all
MAX_TX = 128
MAX_THREADS = 512

#: ROADMAP items that port what this slice refuses
STREAM_ITEM = "ROADMAP A5 / B2 (stream schedule)"


@dataclasses.dataclass
class StreamSpec:
    """Shift-register geometry of a ``schedule="stream"`` plan, as written
    by the reference planner.  Carried as data only, so that reference plan
    dicts round-trip; the port does not lower the stream schedule yet."""

    axis: int = 0
    regions: tuple = ()
    depths: tuple = ()
    rings: tuple = ()
    leads: tuple = ()
    time_tile: int = 1
    plane_tile: int = 1

    def __post_init__(self):
        self.regions = tuple(tuple(int(i) for i in r) for r in self.regions)
        self.depths = tuple({str(f): int(d) for f, d in d.items()}
                            for d in self.depths)
        self.rings = tuple({str(f): int(d) for f, d in d.items()}
                           for d in self.rings)
        self.leads = tuple(int(v) for v in self.leads)
        self.time_tile = max(1, int(self.time_tile))
        self.plane_tile = max(1, int(self.plane_tile))


def stream_spec_to_dict(s: StreamSpec | None) -> dict | None:
    if s is None:
        return None
    return {
        "axis": int(s.axis),
        "regions": [list(r) for r in s.regions],
        "depths": [dict(d) for d in s.depths],
        "rings": [dict(d) for d in s.rings],
        "leads": list(s.leads),
        "time_tile": int(s.time_tile),
        "plane_tile": int(s.plane_tile),
    }


def stream_spec_from_dict(d: dict | None) -> StreamSpec | None:
    if d is None:
        return None
    return StreamSpec(axis=int(d.get("axis", 0)),
                      regions=d.get("regions", ()),
                      depths=d.get("depths", ()),
                      rings=d.get("rings", ()),
                      leads=d.get("leads", ()),
                      time_tile=int(d.get("time_tile", 1)),
                      plane_tile=int(d.get("plane_tile", 1)))


@dataclasses.dataclass
class DataflowPlan:
    # fuse groups: ordered list of lists of op indices
    groups: list
    # output tile shape per axis (one CTA's tile)
    block: tuple
    # dtype for field storage/compute
    dtype: str = "float32"
    # backend: "cuda" | "torch_fused" | "torch_naive"
    backend: str = "cuda"
    # kept for the reference's serialised layout; unused by the port
    interpret: bool = False
    # distributed layout: mesh axis name per grid axis (None = unsharded)
    mesh_axes: tuple | None = None
    # exchange halos every k steps (reference layout; unused by the port)
    halo_every: int = 1
    # iteration schedule: "block" tiles the output, one CTA per tile
    schedule: str = "block"
    # stream geometry of a reference stream plan (data only)
    stream: StreamSpec | None = None
    # temporal blocking depth (stream schedule only)
    time_tile: int = 1
    # spatial unroll width (stream schedule only)
    plane_tile: int = 1

    def __post_init__(self):
        if self.mesh_axes is not None:
            self.mesh_axes = tuple(self.mesh_axes)
        self.block = tuple(self.block)
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; valid: "
                             + ", ".join(repr(s) for s in SCHEDULES))
        self.time_tile = int(self.time_tile)
        if self.time_tile < 1:
            raise ValueError(f"time_tile must be >= 1, got {self.time_tile}")
        if self.time_tile > 1 and self.schedule != "stream":
            raise ValueError(
                "time_tile > 1 is temporal blocking through the stream "
                "sweep; it requires schedule='stream', got "
                f"schedule={self.schedule!r}")
        self.plane_tile = int(self.plane_tile)
        if self.plane_tile < 1:
            raise ValueError(
                f"plane_tile must be >= 1, got {self.plane_tile}")
        if self.plane_tile > 1 and self.schedule != "stream":
            raise ValueError(
                "plane_tile > 1 is spatial unrolling of the stream sweep; "
                f"it requires schedule='stream', got "
                f"schedule={self.schedule!r}")

    def describe(self) -> str:
        g = ", ".join("{" + ",".join(map(str, grp)) + "}" for grp in self.groups)
        return (f"plan(groups=[{g}], block={self.block}, backend={self.backend}, "
                f"schedule={self.schedule}, dtype={self.dtype})")


# --------------------------------------------------------------------------
# Plan serialisation + program fingerprinting (the reference's layout)
# --------------------------------------------------------------------------

#: Version of the serialised plan layout, equal to the reference's.
PLAN_SCHEMA_VERSION = 4


def plan_to_dict(plan: DataflowPlan) -> dict:
    """JSON-safe encoding of a plan (round-trips via :func:`plan_from_dict`)."""
    return {
        "schema": PLAN_SCHEMA_VERSION,
        "groups": [[int(i) for i in grp] for grp in plan.groups],
        "block": [int(b) for b in plan.block],
        "dtype": plan.dtype,
        "backend": plan.backend,
        "interpret": bool(plan.interpret),
        "mesh_axes": (None if plan.mesh_axes is None
                      else list(plan.mesh_axes)),
        "halo_every": int(plan.halo_every),
        "schedule": plan.schedule,
        "stream": stream_spec_to_dict(plan.stream),
        "time_tile": int(plan.time_tile),
        "plane_tile": int(plan.plane_tile),
    }


def plan_from_dict(d: dict) -> DataflowPlan:
    """Tolerant decoding: unknown keys are ignored and missing keys get the
    field defaults."""
    ma = d.get("mesh_axes")
    return DataflowPlan(
        groups=[list(grp) for grp in d["groups"]],
        block=tuple(d["block"]),
        dtype=d.get("dtype", "float32"),
        backend=d.get("backend", "cuda"),
        interpret=bool(d.get("interpret", False)),
        mesh_axes=None if ma is None else tuple(ma),
        halo_every=int(d.get("halo_every", 1)),
        schedule=d.get("schedule", "block"),
        stream=stream_spec_from_dict(d.get("stream")),
        time_tile=int(d.get("time_tile", 1)),
        plane_tile=int(d.get("plane_tile", 1)),
    )


def program_fingerprint(p: Program) -> str:
    """Stable content hash of a program's *semantics* (ops, fields, scalars,
    coefficient axes, field dtypes and boundaries) — equal to the
    reference's fingerprint of the same program."""
    parts = [p.to_text()]
    parts += [f"field:{n}:{f.role.value}:{f.dtype}:{f.boundary}"
              for n, f in sorted(p.fields.items())]
    parts += [f"coeff:{c}:{ax}" for c, ax in sorted(p.coeffs.items())]
    parts.append(f"scalars:{','.join(p.scalars)}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Time-loop update-rule normalisation
# --------------------------------------------------------------------------

#: The accepted update-rule signatures, for error messages and docs.
UPDATE_SIGNATURES = ("update(fields, outputs)",
                     "update(fields, outputs, scalars)")


def adapt_update(update):
    """Normalise a time-loop update rule to ``fn(fields, outputs, scalars)``.

    Accepts ``update(fields, outputs) -> fields`` and
    ``update(fields, outputs, scalars) -> fields``; idempotent.  A callable
    matching neither form raises a :class:`TypeError` naming both.
    """
    if update is None or getattr(update, "_takes_scalars", False):
        return update
    if not callable(update):
        raise TypeError(
            f"update rule must be callable, got {type(update).__name__}; "
            "accepted signatures: " + " or ".join(UPDATE_SIGNATURES))
    try:
        params = list(inspect.signature(update).parameters.values())
    except (TypeError, ValueError):
        params = None            # builtins/C callables: assume the 2-form
    if params is None:
        takes3 = False
    else:
        pos = [q for q in params if q.kind in (q.POSITIONAL_ONLY,
                                               q.POSITIONAL_OR_KEYWORD)]
        required = [q for q in pos if q.default is q.empty]
        var_pos = any(q.kind == q.VAR_POSITIONAL for q in params)
        fits2 = len(required) <= 2 and (len(pos) >= 2 or var_pos)
        fits3 = len(required) <= 3 and (len(pos) >= 3 or var_pos)
        if not fits2 and not fits3:
            raise TypeError(
                f"update rule {getattr(update, '__name__', update)!r} takes "
                f"{len(required)} required positional argument(s); a fused "
                "time-loop update rule must accept one of: "
                + " or ".join(UPDATE_SIGNATURES))
        takes3 = fits3
    if takes3:
        def fn(fields, outputs, scalars, _u=update):
            return _u(fields, outputs, scalars)
    else:
        def fn(fields, outputs, scalars, _u=update):
            return _u(fields, outputs)
    fn._takes_scalars = True
    return fn


# --------------------------------------------------------------------------
# Fused time loop
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TimeLoopSpec:
    """Plan for a fused time loop: one persistent, halo-padded buffer per
    program input field, from which every step's group kernels read their
    windows (no per-step pad), and into which the update writes back."""

    steps: int
    # fields carried across steps (the program's external inputs)
    persistent: list
    # field -> (ndim, 2) carry padding [halo + tile alignment on the hi side]
    field_pad: dict
    # field -> (front_slot, back_slot) logical buffer ids
    double_buffer: dict
    # per fuse group: {field: (ndim,) start offsets of the group's window
    # inside the carry buffer} (0 for transient inputs)
    group_offsets: list
    # how the loop writes the back buffer: "repad" rebuilds interior plus
    # halo slabs in a new buffer; "inplace" copies the new interior into the
    # existing buffer (zero-boundary fields; periodic ones always rebuild)
    carry_write: str = "repad"
    # hi-side tile-alignment slab per axis, already folded into field_pad
    align_hi: tuple = ()

    def describe(self) -> str:
        bufs = ", ".join(f"{f}:{a}/{b}" for f, (a, b)
                         in self.double_buffer.items())
        return (f"time_loop(steps={self.steps}, "
                f"persistent=[{','.join(self.persistent)}], "
                f"double_buffer=[{bufs}])")


def clamp_block(block: Sequence[int], grid: Sequence[int]) -> tuple:
    """The tile a kernel really uses: ``block`` clipped to the grid."""
    return tuple(min(int(b), int(g)) for b, g in zip(block, grid))


def plan_time_loop(p: Program, plan: DataflowPlan, grid: Sequence[int],
                   steps: int, carry_write: str = "repad",
                   group_halos: list | None = None) -> TimeLoopSpec:
    """Size the carry buffers for a fused time loop.

    For the kernel backend a field's carry padding is the elementwise max of
    the window halos of every fuse group consuming it, plus the tile
    alignment padding on the hi side (so any group can read its window
    straight out of the carry through a base offset).  The torch backends
    share the same spec minus alignment, widened to every op's raw reach.
    """
    grid = tuple(int(g) for g in grid)
    ndim = p.ndim
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    persistent = p.input_fields()

    align_hi = np.zeros(ndim, dtype=np.int64)
    if plan.backend == "cuda":
        # mirror build_group_call's tile geometry exactly
        block = clamp_block(plan.block[:ndim], grid)
        tiles = tuple(-(-grid[a] // block[a]) for a in range(ndim))
        align_hi = np.asarray([tiles[a] * block[a] - grid[a]
                               for a in range(ndim)], dtype=np.int64)

    field_pad = {f: _zeros(ndim) for f in persistent}
    if group_halos is None:
        group_halos = [infer_halo(p, grp) for grp in plan.groups]
    for gh in group_halos:
        for f in gh.group_inputs:
            if f in field_pad:
                field_pad[f] = np.maximum(field_pad[f], gh.input_halo)
    # the torch lowerings evaluate every op (no DCE), so their carry must
    # also cover raw access offsets from ops outside the live fuse groups
    if plan.backend != "cuda":
        for op in p.ops:
            for a in op.accesses():
                m = field_pad.get(a.field)
                if m is None:
                    continue
                for ax in range(ndim):
                    o = int(a.offset[ax])
                    m[ax, 0] = max(m[ax, 0], -o)
                    m[ax, 1] = max(m[ax, 1], o)
    for f in persistent:
        field_pad[f][:, 1] += align_hi

    double_buffer = {f: (2 * i, 2 * i + 1) for i, f in enumerate(persistent)}
    group_offsets = []
    for gh in group_halos:
        offs = {}
        for f in gh.group_inputs:
            if f in field_pad:
                offs[f] = tuple(int(field_pad[f][a, 0] - gh.input_halo[a, 0])
                                for a in range(ndim))
            else:
                offs[f] = (0,) * ndim
        group_offsets.append(offs)
    if carry_write not in ("repad", "inplace"):
        raise ValueError(f"unknown carry_write {carry_write!r}")
    return TimeLoopSpec(steps=steps, persistent=persistent,
                        field_pad=field_pad, double_buffer=double_buffer,
                        group_offsets=group_offsets, carry_write=carry_write,
                        align_hi=tuple(int(a) for a in align_hi))


# --------------------------------------------------------------------------
# Shared-memory cost and the block planner
# --------------------------------------------------------------------------

def window_bytes(p: Program, gh, block: Sequence[int], dtype: str) -> int:
    """Bytes of the input windows (tile + input halo, every group input)
    one CTA of a fuse group stages in shared memory."""
    win = np.asarray(block) + gh.input_halo[:, 0] + gh.input_halo[:, 1]
    return int(np.prod(win)) * len(gh.group_inputs) * hw.DTYPE_BYTES[dtype]


def smem_cost(p: Program, plan: DataflowPlan, grid: Sequence[int]) -> int:
    """Bytes of shared memory one CTA of the *largest* group claims.

    The generated kernel stages every group input's window (tile + input
    halo) in shared memory and keeps in-group temps in registers (each
    thread evaluates the temps it needs at every offset it needs them), so
    the claim is the windows alone.  Fused-loop carries do not enlarge it:
    the kernel reads its own window out of an oversized carry through a
    base offset.  Blocks are clipped to the grid as the kernel clips them.
    """
    if plan.schedule == "stream":
        raise NotImplementedError(
            f"shared-memory cost of stream plans: {STREAM_ITEM}")
    blk = clamp_block(plan.block[:p.ndim], grid)
    return max(window_bytes(p, infer_halo(p, grp), blk, plan.dtype)
               for grp in plan.groups)


def cta_threads(block: Sequence[int]) -> tuple:
    """``(tx, ty)``: the threads of the CTA computing ``block``, along the
    contiguous axis and the one before it (each thread loops over the rest
    of the tile)."""
    tx = min(int(block[-1]), MAX_TX)
    ty = min(int(block[-2]) if len(block) > 1 else 1, max(1, MAX_THREADS // tx))
    return tx, ty


def resident_threads(block: Sequence[int], smem: int) -> int:
    """Threads of CTAs of ``block`` claiming ``smem`` bytes each that one
    SM holds at once, as shared memory and the thread and CTA limits allow
    (registers are not known before the kernel is compiled)."""
    spec = hw.H100
    tx, ty = cta_threads(block)
    ctas = min(spec.smem_per_sm // (smem + spec.smem_reserved_per_cta),
               spec.threads_per_sm // (tx * ty), spec.ctas_per_sm)
    return ctas * tx * ty


def pick_block(p: Program, groups: list, grid: Sequence[int], dtype: str,
               smem_budget: int) -> tuple:
    """The tile among :data:`OUTER_TILES` x :data:`LANE_TILES` (clipped to
    the grid) whose windows fit ``smem_budget`` and that keeps the most
    threads resident per SM; among those, the one staging the fewest
    window bytes per grid point (halo re-reads and tile-alignment waste
    included), then the largest."""
    grid = tuple(int(g) for g in grid)
    halos = [infer_halo(p, grp) for grp in groups]
    axes = [sorted({min(t, g) for t in OUTER_TILES}) for g in grid[:-1]]
    axes.append(sorted({min(t, grid[-1]) for t in LANE_TILES}))
    best, best_key = None, None
    for blk in itertools.product(*axes):
        per_group = [window_bytes(p, gh, blk, dtype) for gh in halos]
        smem = max(per_group)
        if smem > smem_budget:
            continue
        tiles = int(np.prod([-(-g // b) for g, b in zip(grid, blk)]))
        staged = sum(per_group) * tiles / int(np.prod(grid))
        key = (resident_threads(blk, smem), -staged, int(np.prod(blk)))
        if best_key is None or key > best_key:
            best, best_key = blk, key
    if best is None:
        smallest = tuple(a[0] for a in axes)
        raise ValueError(
            f"no tile of {p.name!r} fits {smem_budget} B of shared memory "
            f"(smallest tile {smallest} needs "
            f"{max(window_bytes(p, gh, smallest, dtype) for gh in halos)} B)")
    return tuple(int(b) for b in best)


def auto_plan(p: Program, grid: Sequence[int], *, backend: str = "cuda",
              strategy: str = "auto", dtype: str = "float32",
              smem_budget: int = hw.H100.smem_per_block,
              steps: int | None = None, schedule: str = "block",
              time_tile: int = 1, plane_tile: int = 1) -> DataflowPlan:
    """Pick fuse groups and a tile whose windows fit one CTA's shared memory.

    The groups are ``stage_split(p, strategy)``, as in the reference.  The
    tile is :func:`pick_block`'s: the most threads resident per SM, then the
    fewest staged window bytes per point.  ``steps`` is accepted for the
    reference's signature: a fused loop does not change the kernel's
    shared-memory claim.
    """
    grid = tuple(int(g) for g in grid)
    ndim = p.ndim
    if schedule == "stream":
        raise NotImplementedError(f"schedule='stream': {STREAM_ITEM}")
    if time_tile > 1 or plane_tile > 1:
        raise NotImplementedError(
            f"time_tile/plane_tile > 1 belong to the stream schedule: "
            f"{STREAM_ITEM}")
    groups = stage_split(p, strategy)
    blk = pick_block(p, groups, grid, dtype, smem_budget)
    return DataflowPlan(groups=groups, block=blk, dtype=dtype,
                        backend=backend, mesh_axes=(None,) * ndim)
