"""DataflowPlan — the HLS-dialect analogue, planned on Hopper terms (the
port of ``repro.core.schedule``).

A plan is pure data: fuse groups (which ops share one kernel), the output
tile ``block`` one CTA computes (block schedule), and for the stream
schedule the legalised shift-register geometry (``StreamSpec``) with the
requested ``time_tile``/``plane_tile``.  :func:`plan_to_dict` /
:func:`plan_from_dict` use the reference's serialised layout, so a plan
written by the JAX package reads back here unchanged.

Where the reference prices a tile against a TPU VMEM budget with a
128-lane quantum, :func:`smem_cost` prices it against the shared memory one
CTA may use on an H100 (227 KB), and the contiguous axis is tiled in
multiples of a 32-thread warp for coalescing.  Fuse groups are exactly
``passes.stage_split``'s; only the tile differs from the reference.  The
reference's stream plans keep whole planes resident; the port's sweep
kernel tiles the non-stream axes instead (:func:`plan_stream_cta`), so a
stream plan's ``block`` stays the reference's one-plane placeholder and
the CTA tile is derived when the kernel is built.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import itertools
from typing import Sequence

import numpy as np

from .. import hw
from ..kernels.build import toolchain
from . import boundary as bc
from .ir import Access, CoeffRef, Const, Program, ScalarRef
from .passes import _zeros, infer_halo, stage_split

SCHEDULES = ("block", "stream")

#: tile extents the block planner tries: the axis before the contiguous one
#: in powers of two (axis 0 of a 3-D program is swept in chunks), the
#: contiguous axis in one, two or four warps
OUTER_TILES = (1, 2, 4, 8, 16)
LANE_TILES = (32, 64, 128)

#: threads of a CTA: at most this many along the contiguous axis, and in all
MAX_TX = 128
MAX_THREADS = 512

@dataclasses.dataclass
class StreamSpec:
    """Shift-register geometry of a ``schedule="stream"`` plan: the
    legalised regions (op indices), per-region window depths, temp ring
    depths and stream leads, and the *effective* ``time_tile`` and
    ``plane_tile`` (``dataflow.StreamGraph.spec``)."""

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
    # legalised stream geometry (stream schedule only)
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

    def mesh_axes_for(self, ndim: int) -> tuple:
        """Mesh axis names normalised to ``ndim`` entries (None =
        unsharded)."""
        return normalize_mesh_axes(self.mesh_axes, ndim)

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
    parts += [f"field:{n}:{f.role.value}:{f.dtype}:"
              f"{bc.spec_text(f.boundary)}"
              for n, f in sorted(p.fields.items())]
    parts += [f"coeff:{c}:{ax}" for c, ax in sorted(p.coeffs.items())]
    parts.append(f"scalars:{','.join(p.scalars)}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Grid bucketing (the serving layer's shape quantisation)
# --------------------------------------------------------------------------

def program_reach(p: Program) -> np.ndarray:
    """Transitive stencil reach of ``p`` as an ``(ndim, 2)`` array: how far
    any output cell's value depends on input cells, through every
    producer->consumer chain.  This is the halo a serving bucket must keep
    between a request's true grid and the bucket edge so that no in-domain
    read ever observes the bucket boundary."""
    return np.array(infer_halo(p, range(len(p.ops))).input_halo)


def quantize_extent(n: int, *, lane_axis: bool = False,
                    lane: int = hw.BUCKET_LANE) -> int:
    """Round one grid extent up to its bucket quantum.

    Small extents round to the next power of two (few buckets, bounded
    padding waste); extents at or beyond the quantum round to multiples of
    ``lane`` on the contiguous axis (:data:`hw.BUCKET_LANE`, one 128-byte
    line of float32) and of 32 elsewhere — so varied request grids land on
    a small set of compiled shapes.  The reference's policy, with the
    card's quantum in place of the TPU's 128 lanes; ``lane=`` takes any.
    """
    n = int(n)
    if n < 1:
        raise ValueError(f"extent must be >= 1, got {n}")
    quantum = lane if lane_axis else 32
    if n >= quantum:
        return hw.align_up(n, quantum)
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Placement of one request grid inside a quantised serving bucket.

    The request's true ``grid`` sits at ``offset`` (the program's lo-side
    reach) inside ``bucket``; the slab below the offset and everything past
    ``offset + grid`` is boundary extension the serving layer fills (zeros
    or wraparound) and re-normalises every fused step, so in-domain reads
    never observe the bucket edge.
    """

    grid: tuple
    bucket: tuple
    offset: tuple

    def interior(self) -> tuple:
        """Slices selecting the true grid out of a bucket-shaped array."""
        return tuple(slice(o, o + g) for o, g in zip(self.offset, self.grid))


def bucket_for(p: Program, grid: Sequence[int], *,
               lane: int = hw.BUCKET_LANE) -> BucketSpec:
    """Quantised serving bucket for ``grid``: true extent plus the program's
    lo/hi reach, rounded up per :func:`quantize_extent`.  Requests whose
    grids share a bucket share one compiled executor."""
    grid = tuple(int(g) for g in grid)
    if len(grid) != p.ndim:
        raise ValueError(f"grid rank {len(grid)} != program ndim {p.ndim}")
    reach = program_reach(p)
    bucket, offset = [], []
    for a, g in enumerate(grid):
        lo, hi = int(reach[a, 0]), int(reach[a, 1])
        bucket.append(quantize_extent(g + lo + hi,
                                      lane_axis=(a == p.ndim - 1), lane=lane))
        offset.append(lo)
    return BucketSpec(grid=grid, bucket=tuple(bucket), offset=tuple(offset))


#: prefix of the per-axis real grid sizes a serving program carries as
#: scalars (``serve.bucket.serving_program``)
SIZE_SCALAR_PREFIX = "_srv_n"


def serving_domain(p: Program):
    """The real domain of a serving program inside its bucket, or ``None``
    for any other program: ``(lo, idx)``, the domain on axis ``a`` being
    ``[lo[a], lo[a] + n_a)`` with ``lo`` the program's low reach (where
    :func:`bucket_for` places the grid) and ``n_a`` the runtime scalar
    ``p.scalars[idx[a]]``.

    The executables of such a program hold every zero-boundary op's value
    to 0 outside that domain, per batch element, as the exact grid's
    compile does outside the grid: the reference computes temps over the
    whole bucket, so an op that reads in-domain cells from just outside
    the domain gives the consumer a value where the exact grid gives 0
    (tracer_advection's single step is off by about 5e-3 relative there;
    pw_advection, whose ops read inputs only, is exact either way).
    """
    names = [f"{SIZE_SCALAR_PREFIX}{a}" for a in range(p.ndim)]
    if not all(n in p.scalars for n in names):
        return None
    lo = tuple(int(v) for v in program_reach(p)[:, 0])
    return lo, tuple(p.scalars.index(n) for n in names)


def mesh_fingerprint(mesh, mesh_axes) -> str:
    """Stable encoding of a mesh topology for cache keys.

    Two topologies of the same device count (2x4 vs 4x2, or different
    grid-axis assignments) shard different local blocks and move different
    halos, so plans and executors compiled under one must never serve the
    other: each grid axis as ``name:size`` (``-:1`` unsharded), as in the
    reference, then the number of distinct devices the shards sit on, so
    that a plan tuned with four shards on one card never serves four
    cards.  ``"none"`` = unsharded (local)."""
    if mesh is None:
        return "none"
    axes = tuple(mesh_axes if mesh_axes is not None else mesh.axis_names)
    topo = ",".join(f"{a or '-'}:{1 if a is None else int(mesh.shape[a])}"
                    for a in axes)
    return f"{topo}/devices={len(set(mesh.devices.flat))}"


def bucket_fingerprint(p: Program, bucket: Sequence[int], *,
                       backend: str, dtype: str = "float32",
                       schedule: str | None = None,
                       steps: int | None = None,
                       mesh=None, mesh_axes=None,
                       plane_tile: int | None = None) -> str:
    """Cache key of one serving-bucket executor: program semantics
    (boundaries included, via :func:`program_fingerprint`), bucket shape,
    backend and compile options, fused depth, requested sweep unroll width
    (``plane_tile``), mesh topology (:func:`mesh_fingerprint`), the plan
    schema version — a record written by another plan layout reads as a
    miss — and the toolchain the kernels build with (torch and CUDA
    versions, nvcc flags; the reference's ``interpret`` and JAX version
    have no counterpart here)."""
    return "|".join([
        "serve",
        program_fingerprint(p),
        "bucket=" + "x".join(str(int(b)) for b in bucket),
        f"backend={backend}",
        f"dtype={dtype}",
        f"schedule={schedule or 'plan'}",
        f"steps={'single' if steps is None else int(steps)}",
        f"plane_tile={'plan' if plane_tile is None else int(plane_tile)}",
        f"mesh={mesh_fingerprint(mesh, mesh_axes)}",
        f"schema={PLAN_SCHEMA_VERSION}",
        *toolchain(),
    ])


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
# Distributed layout (one mesh shard per sub-domain)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardSpec:
    """Distributed layout of one compiled executable (paper step 9: one
    memory bank per field; here one mesh shard per sub-domain).

    Derived by :func:`make_shard_spec` from the plan's fuse groups: each
    field's halo depth is the elementwise max over every consuming group's
    window halo, so one carry-resident exchange per field per step serves
    all groups (they read their own window geometry out of the exchanged
    buffer).  The planner prices tiles against ``local_grid``, never the
    global domain.
    """

    # mesh axis name per grid axis (None = unsharded axis)
    mesh_axes: tuple
    # mesh axis name -> number of shards along it
    axis_sizes: dict
    local_grid: tuple
    global_grid: tuple
    # field -> (ndim, 2) halo depth of the worst consuming fuse group
    field_halo: dict
    # the plan's stream axis (schedule="stream"; None for block plans).
    # When this axis is itself sharded, the per-shard sweep needs exact,
    # chain-deepened lo-side ghost planes (see dataflow.stream_halo) — the
    # field halos above already price them.
    stream_axis: int | None = None

    def axis_size(self, ax: int) -> int:
        name = self.mesh_axes[ax]
        return 1 if name is None else int(self.axis_sizes[name])

    @property
    def stream_sharded(self) -> bool:
        """True when the plan streams over an axis the mesh decomposes."""
        return (self.stream_axis is not None
                and self.axis_size(self.stream_axis) > 1)

    def describe(self) -> str:
        parts = []
        for ax, name in enumerate(self.mesh_axes):
            parts.append(f"{name or '-'}:{self.axis_size(ax)}")
        stream = ("" if self.stream_axis is None
                  else f", stream_axis={self.stream_axis}"
                       f"{'/sharded' if self.stream_sharded else ''}")
        return (f"shard(mesh=[{','.join(parts)}], local={self.local_grid}, "
                f"global={self.global_grid}{stream})")


def normalize_mesh_axes(mesh_axes: Sequence, ndim: int) -> tuple:
    """Mesh axis names truncated/padded to ``ndim`` entries (None =
    unsharded) — the one normalisation every layer (pipeline, tuner, shard
    spec) uses."""
    ma = tuple(mesh_axes or ())
    return ma[:ndim] + (None,) * (ndim - len(ma))


def shard_local_grid(global_grid: Sequence[int], mesh, mesh_axes: Sequence
                     ) -> tuple:
    """Per-shard sub-domain extents; validates mesh/grid divisibility."""
    global_grid = tuple(int(g) for g in global_grid)
    out = []
    for ax, g in enumerate(global_grid):
        name = mesh_axes[ax] if ax < len(mesh_axes) else None
        n = 1 if name is None else int(mesh.shape[name])
        if g % n:
            raise ValueError(f"grid axis {ax} ({g}) not divisible by mesh "
                             f"axis {name!r} ({n})")
        out.append(g // n)
    return tuple(out)


def make_shard_spec(p: Program, plan: DataflowPlan, global_grid: Sequence[int],
                    mesh, mesh_axes: Sequence,
                    group_halos: list | None = None,
                    stream_axis: int | None = None) -> ShardSpec:
    """Build the :class:`ShardSpec` for ``plan`` over ``mesh``.

    Halo exchange is single-hop (each shard talks to its immediate
    neighbours), so a field's halo may not exceed the local extent of a
    sharded axis — violations raise here, at plan time, naming the lever.
    Pass ``group_halos`` (one :func:`infer_halo` result per fuse group, or
    the stream graph's chain-accumulated region halos) to reuse halos the
    caller already computed.  ``stream_axis`` records the plan's sweep
    axis for stream plans: sharding it is supported — the ``group_halos``
    must then carry the deepened ghost-plane reach, and a sweep (plus
    temporal chain) too deep for the local block fails the single-hop
    check here with the mesh/time_tile levers named.
    """
    ndim = p.ndim
    mesh_axes = normalize_mesh_axes(mesh_axes, ndim)
    named = [a for a in mesh_axes if a is not None]
    if len(set(named)) != len(named):
        raise ValueError(f"mesh axes {mesh_axes} name one mesh axis for two "
                         "grid axes")
    unknown = set(named) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not axes of the "
                         f"mesh {tuple(mesh.axis_names)}")
    local_grid = shard_local_grid(global_grid, mesh, mesh_axes)
    if group_halos is None:
        group_halos = plan_group_halos(p, plan)
    field_halo = {}
    for gh in group_halos:
        for f in gh.group_inputs:
            cur = field_halo.get(f)
            field_halo[f] = (np.array(gh.input_halo) if cur is None
                             else np.maximum(cur, gh.input_halo))
    axis_sizes = {str(k): int(v) for k, v in dict(mesh.shape).items()}
    for ax, name in enumerate(mesh_axes):
        if name is None or axis_sizes.get(str(name), 1) == 1:
            continue
        for f, h in field_halo.items():
            if max(int(h[ax, 0]), int(h[ax, 1])) > local_grid[ax]:
                lever = ("coarsen the mesh axis "
                         f"{name!r} or enlarge the grid")
                if ax == stream_axis:
                    lever = (f"coarsen the mesh axis {name!r}, shallow the "
                             "time_tile chain, or leave the stream axis "
                             "unsharded")
                raise ValueError(
                    f"halo of field {f!r} on axis {ax} "
                    f"({int(h[ax, 0])},{int(h[ax, 1])}) exceeds the local "
                    f"extent {local_grid[ax]}; {lever}")
    return ShardSpec(mesh_axes=mesh_axes, axis_sizes=axis_sizes,
                     local_grid=local_grid,
                     global_grid=tuple(int(g) for g in global_grid),
                     field_halo=field_halo, stream_axis=stream_axis)


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
    # how the loop writes the back buffer: "inplace" (the default) copies
    # the changed interiors into the existing buffer (zero-boundary fields;
    # those periodic on some axis always rebuild); "repad" rebuilds
    # interior plus halo
    # slabs in a new buffer
    carry_write: str = "inplace"
    # hi-side tile-alignment slab per axis, already folded into field_pad;
    # kept apart so a halo refresh (periodic wrap, exchange) treats it as a
    # plain zero slab
    align_hi: tuple = ()
    # distributed layout when the loop runs over a mesh; None = local.
    # With a shard, every extent in this spec is per shard (local_grid).
    shard: ShardSpec | None = None

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
                   steps: int, carry_write: str = "inplace",
                   group_halos: list | None = None,
                   shard: ShardSpec | None = None) -> TimeLoopSpec:
    """Size the carry buffers for a fused time loop.

    For the kernel backend a field's carry padding is the elementwise max of
    the window halos of every fuse group consuming it, plus the tile
    alignment padding on the hi side (so any group can read its window
    straight out of the carry through a base offset); stream plans carry no
    alignment slab (the sweep kernel masks its ragged tiles itself) and
    take their halos from the dataflow regions (:func:`plan_group_halos`).
    The torch backends share the same spec minus alignment, widened to
    every op's raw reach.

    With ``shard``, ``grid`` must be the shard's *local* grid and the spec
    describes the per-shard carry; the distributed executor refreshes the
    halo slabs by exchange at the top of every step.
    """
    grid = tuple(int(g) for g in grid)
    ndim = p.ndim
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    persistent = p.input_fields()

    align_hi = np.zeros(ndim, dtype=np.int64)
    if plan.backend == "cuda" and plan.schedule != "stream":
        # mirror build_group_call's tile geometry exactly
        block = clamp_block(plan.block[:ndim], grid)
        tiles = tuple(-(-grid[a] // block[a]) for a in range(ndim))
        align_hi = np.asarray([tiles[a] * block[a] - grid[a]
                               for a in range(ndim)], dtype=np.int64)

    field_pad = {f: _zeros(ndim) for f in persistent}
    if group_halos is None:
        group_halos = plan_group_halos(p, plan)
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
                        align_hi=tuple(int(a) for a in align_hi),
                        shard=shard)


# --------------------------------------------------------------------------
# The block kernel's CTA (2.5-D: a plane tile sweeping a chunk of axis 0)
# --------------------------------------------------------------------------

#: bytes one ``cp.async`` moves at most; a plane's rows are padded to it
COPY_BYTES = 16

#: registers a block-kernel thread is planned with: the planner counts the
#: CTAs an SM holds at this many, and the kernel's launch bounds ask
#: ptxas for no more than those CTAs allow
BLOCK_REGS = 64


def _round16(n: int) -> int:
    return -(-int(n) // 16) * 16


def _lift3(v, fill) -> tuple:
    v = tuple(v)
    return (fill,) * (3 - len(v)) + v


@dataclasses.dataclass(frozen=True)
class InputRing:
    """The ring of one group input's planes in a block-kernel CTA.

    ``lo``/``hi`` are the input's halo around the tile on each lifted axis
    (on axis 0 around the output plane, so ``hi[0]`` is how many planes
    ahead of the output it is fetched); ``low`` is the lowest plane one
    iteration reads, relative to the sweep front.  The ring holds
    ``slots`` planes: the span one iteration reads plus the plane in
    flight.  A plane is ``rows`` x ``pitch`` elements in the storage
    dtype; column ``shift`` holds the halo's first column, the copy
    starting at the 16-byte boundary below it."""

    field: str
    lo: tuple
    hi: tuple
    low: int
    slots: int
    rows: int
    pitch: int
    shift: int
    itemsize: int
    offset: int = 0

    @property
    def plane(self) -> int:
        return self.rows * self.pitch

    @property
    def nbytes(self) -> int:
        return _round16(self.slots * self.plane * self.itemsize)


@dataclasses.dataclass(frozen=True)
class OpRing:
    """float32 planes of an op that is read at an offset: ``slots`` planes
    of ``extent`` (axes 1 and 2: the tile widened by the op's margins) at
    ``offset`` bytes.  Single-plane rings whose lives within one iteration
    do not overlap share their bytes."""

    out: str
    slots: int
    extent: tuple
    offset: int

    @property
    def plane(self) -> int:
        return self.extent[0] * self.extent[1]


@dataclasses.dataclass(frozen=True)
class BlockLoop:
    """The roots of one level that share their margins: one loop of the
    CTA's threads over their plane, one value-numbered body.  ``flops`` is
    the body's distinct operations (SSA-inlined ops included)."""

    level: int
    margins: tuple
    roots: tuple
    flops: int

    @property
    def lead(self) -> int:
        return self.margins[0][1]

    @property
    def span(self) -> int:
        return self.margins[0][0] + self.margins[0][1]


@dataclasses.dataclass(frozen=True)
class BlockCTA:
    """Geometry of one CTA of a fuse group's block kernel (2.5-D).

    The CTA owns ``tile`` = (chunk, rows, columns) on the lifted axes and
    sweeps its chunk of axis 0 plane by plane, ``warmup`` planes early.
    Every op is evaluated once per point of its margin-extended plane: a
    *root* (an op read at an offset, or a group output) in ``levels``,
    one level per ``__syncthreads``; an op read only at its own point is
    inlined into the roots that read it (``inline``).  A root runs
    ``margins[out][0][1]`` planes ahead of the output.  ``inputs`` and
    ``rings`` are the shared-memory buffers."""

    tile: tuple
    threads: tuple
    margins: dict
    inline: dict
    levels: tuple
    inputs: tuple
    rings: dict
    smem_bytes: int
    warmup: int

    @property
    def ctas_per_sm(self) -> int:
        """CTAs one SM holds, at :data:`BLOCK_REGS` registers a thread (the
        kernel's launch bounds hold ptxas to it)."""
        nt = self.threads[0] * self.threads[1]
        return max(1, resident_threads(self.tile, self.smem_bytes,
                                       BLOCK_REGS) // nt)

    def traffic(self, grid: Sequence[int]) -> tuple:
        """(bytes staged into shared memory, generated operations) per grid
        point over all CTAs of ``grid``: each chunk fetches its planes once
        (halo planes included) and computes each loop on its extended plane
        for the chunk and its warm-up; ragged tiles count in full."""
        n0, n1, n2 = _lift3(grid, 1)
        ch, ta, tb = self.tile
        plane_tiles = -(-n1 // ta) * -(-n2 // tb)
        lens = [min(ch, n0 - c) for c in range(0, n0, ch)]
        staged = sum(r.plane * r.itemsize * (ln + r.lo[0] + r.hi[0])
                     for r in self.inputs for ln in lens)
        ops = sum(lp.flops * (ta + sum(lp.margins[1]))
                  * (tb + sum(lp.margins[2])) * (ln + lp.span)
                  for lv in self.levels for lp in lv for ln in lens)
        pts = n0 * n1 * n2
        return staged * plane_tiles / pts, ops * plane_tiles / pts


def _unique_ops(exprs) -> int:
    """Distinct operation nodes of ``exprs`` (the value numbering's
    count: equal subtrees evaluate once)."""
    seen: set = set()

    def rec(e):
        if isinstance(e, (Access, CoeffRef, Const, ScalarRef)) or e in seen:
            return
        seen.add(e)
        for c in e.children():
            rec(c)

    for e in exprs:
        rec(e)
    return len(seen)


def plan_block_cta(p: Program, group: Sequence[int], block: Sequence[int],
                   dtype: str) -> BlockCTA:
    """The CTA of a fuse group's block kernel computing ``block`` (already
    clipped to the grid; on a 3-D program ``block[0]`` is the chunk of
    axis 0 a CTA sweeps)."""
    gh = infer_halo(p, group)
    ops = [p.ops[i] for i in group]
    margins = {p.ops[i].out: tuple(_lift3(
        [(int(gh.margins[i][a, 0]), int(gh.margins[i][a, 1]))
         for a in range(p.ndim)], (0, 0))) for i in group}
    lead = {out: m[0][1] for out, m in margins.items()}
    produced = set(margins)
    planar = {a.field for op in ops for a in op.accesses()
              if a.field in produced and any(a.offset)}
    roots = [op.out for op in ops
             if op.out in planar or op.out in gh.group_outputs]
    by_out = {op.out: op for op in ops}

    def inlined(op, acc):
        for a in op.accesses():
            if a.field in produced and a.field not in planar \
                    and a.field not in acc:
                inlined(by_out[a.field], acc)
                acc.append(a.field)
        return acc

    inline = {r: tuple(inlined(by_out[r], [])) for r in roots}
    # (field, lifted offset) each root's body reads, inlined ops included
    reads = {r: [(a.field, _lift3(a.offset, 0))
                 for o in (r,) + inline[r] for a in by_out[o].accesses()
                 if a.field not in inline[r]] for r in roots}
    level: dict = {}
    for r in roots:
        level[r] = max([level[f] + 1 for f, o in reads[r]
                        if f in planar and lead[r] + o[0] == lead[f]]
                       + [0])
    ch, ta, tb = _lift3(block, 1)
    isz = hw.DTYPE_BYTES[dtype]
    vec = max(1, COPY_BYTES // isz)
    halo_lo = _lift3(gh.input_halo[:, 0], 0)
    inputs = []
    for f in gh.group_inputs:
        rr = [(margins[r], lead[r], o) for r in roots
              for g, o in reads[r] if g == f]
        lo = tuple(max(m[a][0] - o[a] for m, _, o in rr) for a in range(3))
        hi = tuple(max(m[a][1] + o[a] for m, _, o in rr) for a in range(3))
        low = min(ld + o[0] for _, ld, o in rr)
        shift = (int(halo_lo[2]) - lo[2]) % vec
        inputs.append(InputRing(
            field=f, lo=lo, hi=hi, low=low, slots=hi[0] - low + 2,
            rows=lo[1] + ta + hi[1],
            pitch=-(-(shift + lo[2] + tb + hi[2]) // vec) * vec,
            shift=shift, itemsize=isz))
    # op rings: depth = the planes between the lowest read and the lead
    slots, ext, last = {}, {}, {}
    for j in (r for r in roots if r in planar):
        rr = [(r, o) for r in roots for g, o in reads[r] if g == j]
        slots[j] = lead[j] - min(lead[r] + o[0] for r, o in rr) + 1
        last[j] = max(level[r] for r, _ in rr)
        ext[j] = (ta + sum(margins[j][1]), tb + sum(margins[j][2]))
    off = 0
    placed = []
    for r in inputs:
        placed.append(dataclasses.replace(r, offset=off))
        off += r.nbytes
    rings = {}
    for j in slots:
        if slots[j] > 1:
            rings[j] = OpRing(j, slots[j], ext[j], off)
            off += _round16(4 * slots[j] * ext[j][0] * ext[j][1])
    # single planes: a pool is reused once every plane in it has been read
    pools, where = [], {}
    for j in sorted((j for j in slots if slots[j] == 1),
                    key=lambda j: level[j]):
        nb = _round16(4 * ext[j][0] * ext[j][1])
        free = [k for k, (_, busy) in enumerate(pools) if busy < level[j]]
        fits = [k for k in free if pools[k][0] >= nb]
        k = (min(fits, key=lambda k: pools[k][0]) if fits
             else max(free, key=lambda k: pools[k][0]) if free else None)
        if k is None:
            pools.append([nb, last[j]])
            k = len(pools) - 1
        pools[k] = [max(pools[k][0], nb), last[j]]
        where[j] = k
    pool_off = []
    for size, _ in pools:
        pool_off.append(off)
        off += size
    for j, k in where.items():
        rings[j] = OpRing(j, 1, ext[j], pool_off[k])
    levels = []
    for lv in range(max(level.values()) + 1 if level else 0):
        loops: dict = {}
        for r in roots:
            if level[r] == lv:
                loops.setdefault(margins[r], []).append(r)
        levels.append(tuple(
            BlockLoop(lv, m, tuple(rs), _unique_ops(
                [by_out[o].expr for r in rs for o in (r,) + inline[r]]))
            for m, rs in loops.items()))
    tile = (ch, ta, tb)
    return BlockCTA(tile=tile, threads=cta_threads(tile), margins=margins,
                    inline=inline, levels=tuple(levels),
                    inputs=tuple(placed), rings=rings, smem_bytes=off,
                    warmup=max([sum(margins[r][0]) for r in roots] + [0]))


def smem_cost(p: Program, plan: DataflowPlan, grid: Sequence[int]) -> int:
    """Bytes of shared memory one CTA of the *largest* group claims.

    Block schedule: the block kernel's CTA (:func:`plan_block_cta`): a
    ring of planes per group input in the field dtype, and float32 rings
    of the ops read at an offset, single-plane rings sharing bytes where
    their lives do not overlap.  Fused-loop carries do not enlarge it: the
    kernel reads its planes out of an oversized carry through a base
    offset.  Blocks are clipped to the grid as the kernel clips them.

    Stream schedule: the largest sweep-kernel CTA over the legalised
    regions at the effective ``time_tile``/``plane_tile``
    (:func:`plan_stream_cta`), which replaces the reference's VMEM price
    of whole resident planes.
    """
    grid = tuple(int(g) for g in grid)
    if plan.schedule == "stream":
        from .dataflow import lower_to_dataflow
        graph = lower_to_dataflow(p, plan, grid)
        return max(plan_stream_cta(p, r, grid, graph.time_tile,
                                   graph.plane_tile, plan.dtype).smem_bytes
                   for r in graph.regions)
    blk = clamp_block(plan.block[:p.ndim], grid)
    return max(plan_block_cta(p, grp, blk, plan.dtype).smem_bytes
               for grp in plan.groups)


def plan_group_halos(p: Program, plan: DataflowPlan,
                     stream_sharded: bool = False) -> list:
    """One :class:`~repro_torch.core.passes.GroupHalo` per executed kernel
    of ``plan``: block-schedule fuse groups via :func:`infer_halo`, stream
    regions (post-legalisation, with shift-register stream-axis halos,
    chain-accumulated when ``time_tile > 1``) via the dataflow layer.
    ``stream_sharded`` deepens the stream-axis lo halos for a mesh that
    decomposes the sweep axis.  Carry and shard sizing go through here, so
    the padding always matches what the lowered kernels read."""
    if plan.schedule == "stream":
        from .dataflow import lower_to_dataflow
        return lower_to_dataflow(
            p, plan, stream_sharded=stream_sharded).group_halos()
    return [infer_halo(p, grp) for grp in plan.groups]


# --------------------------------------------------------------------------
# The stream sweep kernel's CTA (2.5-D blocking)
# --------------------------------------------------------------------------

#: tiles of the stream kernel's CTA over the non-stream axes: outer axes in
#: powers of two, the contiguous axis in one, two or four warps
STREAM_OUTER_TILES = (1, 2, 4, 8, 16, 32)

#: registers a sweep-kernel thread is planned with: the planner counts the
#: CTAs an SM holds at this many, and the kernel's launch bounds ask ptxas
#: for no more than those CTAs allow
STREAM_REGS = 64


@dataclasses.dataclass(frozen=True)
class StreamBuffer:
    """One shared-memory buffer of a sweep-kernel CTA: ``slots`` planes of
    ``extent`` (per non-stream axis), rotated by plane index.

    ``key`` is ``("win", field)`` for an input's window (storage dtype; its
    rows padded to 16 bytes, so every row of a plane starts where a
    16-byte copy may land), ``("field", stage, field)`` for a chain
    stage's ring of updated fields, or ``("op", stage, out)`` for an op's
    result plane or temp ring (both float32)."""

    key: tuple
    slots: int
    extent: tuple
    itemsize: int

    @property
    def nbytes(self) -> int:
        raw = self.slots * int(np.prod(self.extent)) * self.itemsize
        return -(-raw // 16) * 16


@dataclasses.dataclass(frozen=True)
class StreamCTA:
    """Geometry of one CTA of a region's sweep kernel: its tile of the
    non-stream axes, threads, shared-memory buffers, and the chunk of the
    stream axis it owns (``warmup`` planes before the chunk are computed
    again so every window, ring and chain stage is exact at its start).
    ``ctas_per_sm`` is what one SM holds at :data:`STREAM_REGS` registers a
    thread (the kernel's launch bounds)."""

    tile: tuple
    threads: tuple
    buffers: tuple
    chunk: int
    n_chunks: int
    warmup: int
    tiles: tuple
    ctas_per_sm: int = 1

    @property
    def smem_bytes(self) -> int:
        return sum(b.nbytes for b in self.buffers)

    @property
    def ctas(self) -> int:
        return int(np.prod(self.tiles)) * self.n_chunks

    def staged_bytes_per_point(self, grid: Sequence[int],
                               front_depth: dict) -> float:
        """Bytes the CTAs stage into shared memory per grid point: each
        window's padded rows for every plane a chunk sweeps (warm-up and
        the planes below its first one included); ragged tiles count in
        full.  ``front_depth[f]`` is the planes each CTA fetches beyond
        the ones it sweeps (the window depth less one, plus the chain's
        lead)."""
        grid = tuple(int(g) for g in grid)
        n0 = grid[0]
        swept = sum(min(self.chunk, n0 - c0) + min(self.warmup, c0)
                    for c0 in range(0, n0, self.chunk))
        staged = 0
        for b in self.buffers:
            if b.key[0] == "win":
                planes = swept + self.n_chunks * front_depth[b.key[1]]
                staged += int(np.prod(b.extent)) * b.itemsize * planes
        return staged * int(np.prod(self.tiles)) / int(np.prod(grid))


def stream_stage_add(region) -> np.ndarray:
    """(ndim, 2) halo step each remaining chain stage adds on the
    non-stream axes (the region's per-step input halo; 0 on axis 0)."""
    add = np.array(region.halo.input_halo, dtype=np.int64)
    add[0] = 0
    return add


def stream_levels(p: Program, region) -> dict:
    """Level of each op of ``region`` in the sweep kernel: one above every
    op whose value at the *same* plane it reads (ring reads of past
    planes do not count); a barrier parts two levels."""
    lvl: dict = {}
    for i in region.ops:
        op = p.ops[i]
        lvl[op.out] = max([lvl[a.field] + 1 for a in op.accesses()
                           if a.field in lvl and int(a.offset[0]) == 0]
                          + [0])
    return lvl


def stream_update_fuses(p: Program, region) -> bool:
    """Whether the sweep kernel applies the update rule in the loop of
    the region's outputs, at the point each thread has just computed: the
    outputs have no margin on the non-stream axes (so their loop covers
    the update's extent, point for point) and sit in the last level."""
    lvl = stream_levels(p, region)
    outs = [(i, p.ops[i].out) for i in region.ops
            if p.ops[i].out in set(region.halo.group_outputs)]
    if not outs:
        return False
    last = max(lvl.values())
    return all(lvl[o] == last and not np.asarray(
        region.halo.margins[i])[1:].any() for i, o in outs)


def stream_plane_ops(p: Program, region, updates: bool) -> list:
    """Ops of ``region`` whose results a CTA keeps in shared memory: those
    read by another op of the region (same plane or ring), and, when the
    kernel applies the update rule (``updates``: a chain, or its
    remainder) in a loop of its own, the region's outputs, which the rule
    reads (:func:`stream_update_fuses`)."""
    produced = {p.ops[i].out for i in region.ops}
    keep = {a.field for i in region.ops for a in p.ops[i].accesses()
            if a.field in produced}
    if updates and not stream_update_fuses(p, region):
        keep |= produced & set(region.halo.group_outputs)
    return [p.ops[i].out for i in region.ops if p.ops[i].out in keep]


def stream_buffers(p: Program, region, time_tile: int, plane_tile: int,
                   tile: Sequence[int], dtype: str,
                   updates: bool | None = None) -> list:
    """The shared-memory buffers of one CTA computing ``tile`` (one extent
    per non-stream axis), in layout order: every input's window ring of
    ``depth + plane_tile - 1`` planes read by one step of the sweep plus
    the ``plane_tile`` planes in flight, widened by the chain's
    T-fold halo, its rows padded to 16 bytes; per chain stage after the
    first, a ring of ``depth`` updated planes of each field; per stage, a
    plane (or a ring) of each op in :func:`stream_plane_ops` at the
    stage's margin.  ``updates`` defaults to ``time_tile > 1``."""
    T, P = max(1, int(time_tile)), max(1, int(plane_tile))
    if updates is None:
        updates = T > 1
    gh = region.halo
    ndim = p.ndim
    add = stream_stage_add(region)
    span = add[1:, 0] + add[1:, 1]
    tile = np.asarray(tile, dtype=np.int64)
    isz = hw.DTYPE_BYTES[dtype]
    vec = max(1, COPY_BYTES // isz)
    win = [int(x) for x in tile + T * span]
    win[-1] = -(-win[-1] // vec) * vec
    bufs = [StreamBuffer(("win", f),
                         int(region.depths[f]) + 2 * P - 1,
                         tuple(win), isz)
            for f in gh.group_inputs]
    for s in range(1, T):
        bufs += [StreamBuffer(("field", s, f), int(region.depths[f]),
                              tuple(int(x) for x in tile + (T - s) * span), 4)
                 for f in gh.group_inputs]
    keep = stream_plane_ops(p, region, updates)
    margins = {p.ops[i].out: gh.margins[i] for i in region.ops}
    for s in range(T):
        for out in keep:
            m = margins[out][1:ndim] + (T - 1 - s) * add[1:]
            bufs.append(StreamBuffer(
                ("op", s, out), int(region.rings.get(out, 1)),
                tuple(int(x) for x in tile + m[:, 0] + m[:, 1]), 4))
    return bufs


def stream_warmup(p: Program, region, time_tile: int) -> int:
    """Planes a CTA computes before the first plane of its chunk so that
    everything it stores is exact: the longest chain of temp-ring
    back-references, plus, per chain stage after the first, the deepest
    reach below the output plane of the region's inputs (the reference's
    sharded-sweep lo halo, ``dataflow.stream_halo(stream_sharded=True)``).
    """
    ops = list(region.ops)
    producer = {p.ops[i].out: i for i in ops}
    back = {i: 0 for i in ops}
    for i in reversed(ops):
        for a in p.ops[i].accesses():
            if a.field in producer:
                j = producer[a.field]
                back[j] = max(back[j], back[i] - int(a.offset[0]))
    reach = max([back[i] - int(a.offset[0]) for i in ops
                 for a in p.ops[i].accesses() if a.field not in producer]
                + [0])
    return max(back.values()) + (max(1, int(time_tile)) - 1) * reach


def plan_stream_cta(p: Program, region, grid: Sequence[int], time_tile: int,
                    plane_tile: int, dtype: str,
                    smem_budget: int = hw.H100.smem_per_block,
                    tile: Sequence[int] | None = None,
                    chunk: int | None = None,
                    updates: bool | None = None) -> StreamCTA:
    """The CTA of a region's sweep kernel on the H100 (2.5-D blocking).

    Tile: among :data:`STREAM_OUTER_TILES` x :data:`LANE_TILES` (clipped to
    the grid) whose buffers fit ``smem_budget``, the one keeping the most
    threads resident per SM (at :data:`STREAM_REGS` registers a thread),
    then the fewest buffer bytes per output point, then the largest.
    Chunks: :func:`sweep_chunk`.  ``tile`` and ``chunk`` override the
    choice (tests); ``updates`` is :func:`stream_buffers`'."""
    grid = tuple(int(g) for g in grid)
    T, P = max(1, int(time_tile)), max(1, int(plane_tile))

    def block3(t):
        return (1,) * (3 - len(t)) + tuple(t)

    if tile is None:
        axes = [sorted({min(t, g) for t in STREAM_OUTER_TILES})
                for g in grid[1:-1]]
        axes.append(sorted({min(t, grid[-1]) for t in LANE_TILES}))
        best, best_key = None, None
        for t in itertools.product(*axes):
            smem = sum(b.nbytes for b in stream_buffers(p, region, T, P, t,
                                                        dtype, updates))
            if smem > smem_budget:
                continue
            key = (resident_threads(block3(t), smem, STREAM_REGS),
                   -smem / int(np.prod(t)), int(np.prod(t)))
            if best_key is None or key > best_key:
                best, best_key = t, key
        if best is None:
            raise ValueError(
                f"no sweep-kernel tile of {p.name!r} region {region.ops} "
                f"fits {smem_budget} B of shared memory at time_tile={T}, "
                f"plane_tile={P}")
        tile = best
    tile = tuple(min(int(t), g) for t, g in zip(tile, grid[1:]))
    bufs = tuple(stream_buffers(p, region, T, P, tile, dtype, updates))
    smem = sum(b.nbytes for b in bufs)
    threads = cta_threads(block3(tile))
    per_sm = resident_threads(block3(tile), smem, STREAM_REGS) \
        // (threads[0] * threads[1])
    if smem > smem_budget or per_sm < 1:
        raise ValueError(f"sweep-kernel tile {tile} of {p.name!r} region "
                         f"{region.ops} does not fit {smem_budget} B of "
                         "shared memory")
    tiles = tuple(-(-g // t) for g, t in zip(grid[1:], tile))
    warm = stream_warmup(p, region, T)
    n0 = grid[0]
    if chunk is None:
        chunk = sweep_chunk(n0, int(np.prod(tiles)), per_sm,
                            warm + (T - 1) * int(region.lead))
    chunk = max(1, min(int(chunk), n0))
    return StreamCTA(tile=tile, threads=threads, buffers=bufs, chunk=chunk,
                     n_chunks=-(-n0 // chunk), warmup=warm, tiles=tiles,
                     ctas_per_sm=per_sm)


def cta_threads(block: Sequence[int]) -> tuple:
    """``(tx, ty)``: the threads of the CTA computing ``block``, along the
    contiguous axis and the one before it (each thread loops over the rest
    of the tile)."""
    tx = min(int(block[-1]), MAX_TX)
    ty = min(int(block[-2]) if len(block) > 1 else 1, max(1, MAX_THREADS // tx))
    return tx, ty


def resident_threads(block: Sequence[int], smem: int,
                     regs: int | None = None) -> int:
    """Threads of CTAs of ``block`` claiming ``smem`` bytes each that one
    SM holds at once, as shared memory and the thread and CTA limits allow,
    and, given ``regs`` registers a thread, the register file (registers
    are not known before the kernel is compiled: a kernel planned with
    ``regs`` holds ptxas to them through its launch bounds)."""
    spec = hw.H100
    tx, ty = cta_threads(block)
    ctas = min(spec.smem_per_sm // (smem + spec.smem_reserved_per_cta),
               spec.threads_per_sm // (tx * ty), spec.ctas_per_sm)
    if regs is not None:
        ctas = min(ctas, spec.registers_per_sm // (regs * tx * ty))
    return ctas * tx * ty


def sweep_chunk(n0: int, n_tiles: int, ctas_per_sm: int, extra: int) -> int:
    """Planes of axis 0 one CTA sweeps, when ``n_tiles`` tiles of the other
    axes each sweep ``n0`` planes and a CTA computes ``extra`` planes
    before its chunk: the number of chunks that minimises the modelled
    time, waves of CTAs (132 SMs times ``ctas_per_sm``) times the planes a
    CTA sweeps, then the fewest chunks; no chunk is shorter than four
    times ``extra`` (nor 16 planes).

    Why waves of planes: a CTA's time is its planes, warm-up included,
    whatever else runs (its input planes arrive while it computes, and
    its SM holds the ``ctas_per_sm`` the planner sized for latency and
    barriers to hide behind one another).  So a slot without a CTA is
    lost, and so is each chunk's warm-up, and the model leaves SMs idle
    only where every chunking that fills them costs more: a four-step
    chain at one CTA an SM over 64 tiles of 512 planes takes two chunks
    (128 CTAs of 256 + 6 planes, one wave, four SMs idle), since three
    need a second wave (2 x 177 planes) and chunks short enough to fill
    the slots evenly pay their six warm-up planes again and again.
    Filling the slots at least once is what matters: a further wave of
    shorter chunks costs little, a chunking that leaves half the slots
    empty a good deal.  The sweep and the block kernel share this
    model."""
    slots = hw.H100.sms * ctas_per_sm
    shortest = max(16, 4 * extra)

    def modelled(n):
        waves = -(-n_tiles * n // slots)
        return waves * (-(-n0 // n) + extra), n

    n = min(range(1, max(1, n0 // shortest) + 1), key=modelled)
    return -(-n0 // n)


def feasible_blocks(p: Program, groups: list, grid: Sequence[int],
                    dtype: str, smem_budget: int) -> list:
    """Every block kernel tile whose CTAs fit ``smem_budget``, best first
    (the order :func:`pick_block` ranks by, ties in enumeration order).
    Plane tiles range over :data:`OUTER_TILES` x :data:`LANE_TILES` (the
    axis before the contiguous one, and the contiguous one; clipped to the
    grid), ranked by the threads resident per SM (at :data:`BLOCK_REGS`
    registers a thread), then at least two CTAs an SM (one CTA's barriers
    leave the SM to the other), then the fewest bytes staged per grid
    point, then the fewest operations generated per point, then the
    largest tile.  On a 3-D program ``block[0]`` is the chunk of axis 0
    one CTA sweeps (:func:`sweep_chunk`, with the groups' deepest
    warm-up).  Raises when no tile fits."""
    grid = tuple(int(g) for g in grid)
    sweep = len(grid) == 3
    axes = [sorted({min(t, g) for t in OUTER_TILES}) for g in grid[-2:-1]]
    axes.append(sorted({min(t, grid[-1]) for t in LANE_TILES}))
    ranked, smallest = [], None
    for tile in itertools.product(*axes):
        blk = (1,) * sweep + tile
        ctas = [plan_block_cta(p, grp, blk, dtype) for grp in groups]
        smem = max(c.smem_bytes for c in ctas)
        smallest = smallest or (tile, smem)
        if smem > smem_budget:
            continue
        threads = resident_threads(blk, smem, BLOCK_REGS)
        per_sm = threads // (ctas[0].threads[0] * ctas[0].threads[1])
        if sweep:
            n_tiles = int(np.prod([-(-g // t) for g, t in zip(grid[1:],
                                                               tile)]))
            blk = (sweep_chunk(grid[0], n_tiles, max(1, per_sm),
                               max(c.warmup for c in ctas)),) + tile
            ctas = [dataclasses.replace(c, tile=blk) for c in ctas]
        staged, ops = np.sum([c.traffic(grid) for c in ctas], axis=0)
        key = (threads, min(per_sm, 2), -staged, -ops, int(np.prod(tile)))
        ranked.append((key, tuple(int(b) for b in blk)))
    if not ranked:
        raise ValueError(
            f"no tile of {p.name!r} fits {smem_budget} B of shared memory "
            f"(smallest plane tile {smallest[0]} needs {smallest[1]} B)")
    # a stable sort: equal keys keep their enumeration order
    ranked.sort(key=lambda kb: kb[0], reverse=True)
    return [blk for _, blk in ranked]


def pick_block(p: Program, groups: list, grid: Sequence[int], dtype: str,
               smem_budget: int) -> tuple:
    """The block kernel's tile: the first of :func:`feasible_blocks`."""
    return feasible_blocks(p, groups, grid, dtype, smem_budget)[0]


def auto_plan(p: Program, grid: Sequence[int], *, backend: str = "cuda",
              strategy: str = "auto", dtype: str = "float32",
              smem_budget: int = hw.H100.smem_per_block,
              steps: int | None = None, schedule: str = "block",
              time_tile: int = 1, plane_tile: int = 1) -> DataflowPlan:
    """Pick fuse groups and a tile whose CTA fits one CTA's shared memory.

    The groups are ``stage_split(p, strategy)``, as in the reference.  The
    tile is :func:`pick_block`'s: the most threads resident per SM, then
    two CTAs an SM, then the fewest staged bytes and generated operations
    per point.  ``steps`` is accepted for the reference's signature: a
    fused loop does not change the kernel's shared-memory claim.  ``schedule="stream"`` plans the sweep instead
    (:func:`_auto_plan_stream`).
    """
    grid = tuple(int(g) for g in grid)
    ndim = p.ndim
    groups = stage_split(p, strategy)
    if schedule == "stream":
        return _auto_plan_stream(p, grid, groups, backend=backend,
                                 dtype=dtype, smem_budget=smem_budget,
                                 time_tile=time_tile, plane_tile=plane_tile)
    if time_tile > 1:
        raise ValueError("time_tile > 1 requires schedule='stream' "
                         "(temporal blocking chains the stream sweep)")
    if plane_tile > 1:
        raise ValueError("plane_tile > 1 requires schedule='stream' "
                         "(spatial unrolling widens the stream sweep)")
    blk = pick_block(p, groups, grid, dtype, smem_budget)
    return DataflowPlan(groups=groups, block=blk, dtype=dtype,
                        backend=backend, mesh_axes=(None,) * ndim)


def _auto_plan_stream(p: Program, grid: tuple, groups: list, *,
                      backend: str, dtype: str, smem_budget: int,
                      time_tile: int = 1,
                      plane_tile: int = 1) -> DataflowPlan:
    """Stream-scheduled plan: one shift-register sweep over the outer axis
    per legalised region.  ``block`` records the reference's degenerate
    one-plane tile; the CTA's tile over the non-stream axes is derived when
    the kernel is built (:func:`plan_stream_cta`), and it shrinks before
    anything else does.  Only when no tile fits ``smem_budget`` do the
    reference's levers apply, in its order: a narrower plane unroll, then a
    shallower chain, then a finer region split."""
    if backend != "cuda":
        raise ValueError(
            f"schedule='stream' is a CUDA dataflow schedule; backend "
            f"{backend!r} has no streaming lowering")
    from .dataflow import lower_to_dataflow
    ndim = p.ndim
    block = (1,) + grid[1:]

    def build(groups, tile, ptile):
        plan = DataflowPlan(groups=groups, block=block, dtype=dtype,
                            backend=backend, mesh_axes=(None,) * ndim,
                            schedule="stream", time_tile=tile,
                            plane_tile=ptile)
        graph = lower_to_dataflow(p, plan, grid)
        plan.stream = graph.spec()
        return plan, graph

    def fits(graph):
        try:
            for r in graph.regions:
                plan_stream_cta(p, r, grid, graph.time_tile,
                                graph.plane_tile, dtype, smem_budget)
        except ValueError:          # no tile of some region fits
            return False
        return True

    tile = max(1, int(time_tile))
    ptile = max(1, int(plane_tile))
    plan, graph = build(groups, tile, ptile)
    while not fits(graph) and ptile > 1:
        ptile //= 2
        plan, graph = build(groups, tile, ptile)
    while not fits(graph) and tile > 1:
        tile //= 2
        plan, graph = build(groups, tile, ptile)
    if not fits(graph) and any(len(g) > 1 for g in groups):
        plan, _ = build(stage_split(p, "per_field"), tile, ptile)
    return plan
