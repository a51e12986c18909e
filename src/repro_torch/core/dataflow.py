"""Streaming dataflow IR — the HLS-dialect analogue (paper §3.2).

The paper's middle layer sits between the ``stencil`` dialect and the
hardware: an explicit dataflow graph of streams and shift-register window
buffers in which *each input element is read from external memory exactly
once* and reused across the full stencil window (Fig. 2's 3/9/27-value
buffers).  This module is that layer (the port of
``repro.core.dataflow``, unchanged but for its docstrings):

    stencil IR  --lower_to_dataflow-->  StreamGraph  --lower_stream-->  CUDA

A :class:`StreamGraph` holds one :class:`StreamRegion` per fuse group
(post-legalisation).  Each region is a small dataflow pipeline

    Load(field) -> Window(field, depth) -> Compute(op)* -> Store(field)

streamed plane-by-plane along the **outer** grid axis (axis 0; the
contiguous lane axis stays vectorised inside every plane):

* ``Window`` nodes are the shift registers: a rolling buffer of ``depth``
  planes per input field, where ``depth = lo-reach + region lead + 1`` is
  computed from the stencil access offsets.  One new plane enters per
  stream step; every reuse is a slice resident in shared memory.
* in-region producer->consumer dependencies along the stream axis become
  **ring buffers** over the producer's past planes (``Compute.ring``)
  instead of the block schedule's overlapped-tiling recompute — streamed
  dependencies are recompute-free by construction.
* margins along the *non-stream* axes still follow
  :func:`~repro_torch.core.passes.infer_halo`-style propagation (the plane is
  evaluated slightly wide so consumers can shift within it).

Legalisation (:func:`legalize_stream_groups`) splits a fuse group wherever
streaming cannot honour a dependency in one sweep:

* a temp read at a **positive** stream offset would need a plane the
  pipeline has not produced yet (would require skewing) — split;
* a **periodic** temp read at a negative stream offset would need the end
  of the sweep at its beginning (wraparound is not yet resident) — split.

Split intermediates are materialised in device memory between regions, exactly like
the paper's inter-stage streams; external inputs never force a split (the
orchestrator pads them — zero slabs or torus wraparound — before the sweep).

**Temporal blocking** (``plan.time_tile = T > 1``, the paper's chained
timestep compute regions / the wafer-scale follow-up's pipelined time
steps): one sweep advances T time steps by chaining T copies of the
region's compute stage inside the kernel, with the fused-loop update rule
applied plane-wise between stages.  Chain stage ``s+1`` trails stage ``s``
by the region's stream lead, so halo margins and window-buffer depths
accumulate per chained step (:func:`chained_halo`), and each input plane is
fetched from device memory once per T steps.  The chain legalises like regions do —
:func:`chain_split_reason` demotes the *effective* tile (carried on
``StreamSpec.time_tile``) to 1 wherever one sweep cannot honour the chain:
multi-region programs (step intermediates materialise in device memory
between sweeps), periodic persistent fields (the updated field's wraparound planes
are not resident mid-sweep — the same rule that splits periodic temp
back-references), or regions that do not see every persistent field (the
update rule consumes them all).

**Spatial unrolling** (``plan.plane_tile = P > 1``, the paper's parallel
processing elements consuming multiple contiguous points per cycle): one
sweep step loads and computes P consecutive planes, shrinking the
sweep grid to ``ceil(n_steps / P)`` steps while keeping per-plane
semantics identical — the window shifts by P planes at a time and every
virtual step replays the single-plane pipeline.  Unlike the chain, plane
unrolling is legality-free by construction (rings, coefficients and
periodic wraparound all key off the *virtual* step), so the only demotion
(:func:`plane_split_reason`, effective value on ``StreamSpec.plane_tile``)
is geometric: P planes per step need at least P output planes in the
(shard-local) stream extent.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..obs.events import ChainDemoted, PlaneDemoted
from ..obs.trace import current_tracer
from .ir import FieldRole, Program
from .passes import GroupHalo, _zeros
from .schedule import StreamSpec

STREAM_AXIS = 0


# --------------------------------------------------------------------------
# Graph nodes (pure description — the lowering in lower_stream.py consumes
# the region geometry, the nodes document/validate the pipeline structure)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Load:
    """One plane of ``field`` enters the region from device memory per
    stream step."""

    field: str


@dataclasses.dataclass(frozen=True)
class Window:
    """Shift-register window buffer: ``depth`` resident planes of ``field``.

    ``lo`` planes of reach behind the output plane plus the region's lead
    ahead of it; each plane is loaded once and read ``depth`` times as it
    shifts through."""

    field: str
    depth: int
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class Compute:
    """Evaluate program op ``op`` at the output plane.

    ``ring > 0`` keeps that many planes of the result resident so in-region
    consumers can read past planes (stream-axis dependencies without
    recompute)."""

    op: int
    out: str
    ring: int = 0


@dataclasses.dataclass(frozen=True)
class Store:
    """One plane of ``field`` leaves the region to device memory per stream
    step."""

    field: str


@dataclasses.dataclass
class StreamRegion:
    """One streamed pipeline: a legalised fuse group plus its geometry."""

    ops: list                   # program op indices, in order
    nodes: list                 # Load/Window/Compute/Store pipeline
    halo: GroupHalo             # stream-aware margins + window halo
    depths: dict                # input field -> window buffer depth (planes)
    rings: dict                 # temp field -> ring buffer depth (planes)
    lead: int                   # stream-front lead over the output plane

    def describe(self) -> str:
        d = ",".join(f"{f}:{v}" for f, v in self.depths.items())
        return (f"region(ops={self.ops}, depths=[{d}], lead={self.lead})")


@dataclasses.dataclass
class StreamGraph:
    """The full dataflow program: ordered regions over one stream axis.

    ``time_tile`` is the *effective* temporal-blocking depth: the number of
    chained timestep stages one sweep advances (1 = no chaining, either
    because none was requested or because :func:`chain_split_reason` split
    the chain back to single steps).  ``plane_tile`` is the *effective*
    spatial-unrolling width: how many consecutive planes one sweep grid
    step advances (1 = plane-by-plane, either because none was requested
    or because :func:`plane_split_reason` demoted it)."""

    program: str
    axis: int
    regions: list
    time_tile: int = 1
    plane_tile: int = 1
    # the stream axis is domain-decomposed across a mesh: region halos were
    # built with :func:`stream_halo`'s sharded lo-propagation (ghost planes
    # must be *exact*, not maskable out-of-domain warm-up), and chain
    # accumulation deepens the lo side too (:func:`chained_halo`)
    stream_sharded: bool = False

    def spec(self) -> StreamSpec:
        """The plan-resident summary (what the tuner's cache round-trips)."""
        return StreamSpec(
            axis=self.axis,
            regions=tuple(tuple(r.ops) for r in self.regions),
            depths=tuple(dict(r.depths) for r in self.regions),
            rings=tuple(dict(r.rings) for r in self.regions),
            leads=tuple(r.lead for r in self.regions),
            time_tile=self.time_tile,
            plane_tile=self.plane_tile,
        )

    def group_halos(self) -> list:
        """One :class:`~repro_torch.core.passes.GroupHalo` per *lowered kernel*:
        the region halos, chain-accumulated when this graph temporal-blocks
        (carry/shard sizing must cover what the chained kernels slice)."""
        return [chained_halo(r.halo, self.time_tile,
                             stream_sharded=self.stream_sharded)
                for r in self.regions]

    def to_text(self) -> str:
        """HLS-dialect-style dump (docs, debugging, golden tests)."""
        tt = f" time_tile={self.time_tile}" if self.time_tile > 1 else ""
        pt = f" plane_tile={self.plane_tile}" if self.plane_tile > 1 else ""
        lines = [f"dataflow.graph @{self.program} "
                 f"stream_axis={self.axis}{tt}{pt} {{"]
        for ri, r in enumerate(self.regions):
            lines.append(f"  dataflow.region @{ri} lead={r.lead} {{")
            for n in r.nodes:
                if isinstance(n, Load):
                    lines.append(f"    %{n.field} = dataflow.load")
                elif isinstance(n, Window):
                    lines.append(
                        f"    %{n.field}.win = dataflow.window(%{n.field}) "
                        f"depth={n.depth} reach=(-{n.lo},+{n.hi})")
                elif isinstance(n, Compute):
                    ring = f" ring={n.ring}" if n.ring else ""
                    lines.append(
                        f"    %{n.out} = dataflow.compute op#{n.op}{ring}")
                elif isinstance(n, Store):
                    lines.append(f"    dataflow.store %{n.field}")
            lines.append("  }")
        lines.append("}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Legalisation: which fuse groups can stream in one sweep?
# --------------------------------------------------------------------------


def stream_split_reason(p: Program, produced: set, op_index: int
                        ) -> str | None:
    """Why op ``op_index`` cannot join a region that produced ``produced``
    (None = it can)."""
    op = p.ops[op_index]
    for a in op.accesses():
        if a.field not in produced:
            continue
        o0 = int(a.offset[STREAM_AXIS])
        if o0 > 0:
            return (f"op {op.name or op.out!r} reads {a.field!r} at stream "
                    f"offset +{o0} (future plane)")
        if o0 < 0 and p.fields[a.field].boundary == "periodic":
            return (f"op {op.name or op.out!r} reads periodic temp "
                    f"{a.field!r} at stream offset {o0} (wraparound not "
                    "resident)")
    return None


def legalize_stream_groups(p: Program, groups: Sequence) -> list:
    """Split fuse groups so every region streams in a single forward sweep.

    Greedy in program order: an op that needs a future plane of an in-region
    temp (positive stream offset) or the wraparound of a periodic temp
    starts a new region; the temp then travels through device memory between regions,
    where the orchestrator can pad it like any other field."""
    out = []
    for grp in groups:
        cur: list = []
        produced: set = set()
        for i in grp:
            if cur and stream_split_reason(p, produced, i) is not None:
                out.append(cur)
                cur, produced = [], set()
            cur.append(i)
            produced.add(p.ops[i].out)
        if cur:
            out.append(cur)
    return out


# --------------------------------------------------------------------------
# Temporal-blocking (time_tile) chain legalisation
# --------------------------------------------------------------------------


def chain_split_reason(p: Program, regions: Sequence) -> str | None:
    """Why T > 1 timestep stages cannot chain through one sweep (None = they
    can).  The rules mirror region legalisation, applied at the step level:

    * **multiple regions** — step intermediates materialise in device
      memory between region sweeps, so the chain would break mid-step;
    * **periodic persistent field** — stage ``s+1`` reads the *updated*
      field, whose wraparound planes are produced in-sweep and are not
      resident (the periodic-temp back-reference rule, one level up);
    * **region inputs != persistent fields** — the update rule consumes
      every persistent field, so each chained stage must have all of them
      resident as planes.
    """
    if len(regions) != 1:
        return (f"program streams as {len(regions)} regions; chained steps "
                "would need inter-region intermediates resident mid-sweep")
    persistent = p.input_fields()
    for f in persistent:
        if p.fields[f].boundary == "periodic":
            return (f"persistent field {f!r} is periodic: the updated "
                    "field's wraparound planes are not resident mid-sweep")
    region = regions[0]
    inputs = {a.field for i in region for a in p.ops[i].accesses()
              if a.field not in {p.ops[j].out for j in region}}
    if not inputs <= set(persistent):
        return ("region reads non-persistent inputs "
                f"{sorted(inputs - set(persistent))}")
    if set(persistent) - inputs:
        # the update rule needs planes of every persistent field; fields
        # the stencil never reads have no window to chain through
        return ("persistent field(s) "
                f"{sorted(set(persistent) - inputs)} not read by the "
                "region; chained stages would lack their planes")
    return None


def effective_time_tile(p: Program, regions: Sequence, requested: int) -> int:
    """The chain depth one sweep can actually honour: the requested
    ``time_tile`` when :func:`chain_split_reason` allows it, else 1."""
    requested = max(1, int(requested))
    if requested == 1:
        return 1
    return 1 if chain_split_reason(p, regions) is not None else requested


def plane_split_reason(p: Program, plane_tile: int,
                       grid: Sequence[int] | None = None) -> str | None:
    """Why ``P > 1`` planes cannot advance per sweep grid step (None = they
    can).  Mirrors :func:`chain_split_reason`, one axis over: plane
    unrolling replays the single-plane pipeline per *virtual* step, so
    rings, coefficient reads and periodic wraparound are legal by
    construction and the only constraint is geometric — a P-plane step
    needs at least P output planes in the (shard-local) stream extent,
    otherwise the whole sweep degenerates to warm-up/remainder handling."""
    P = max(1, int(plane_tile))
    if P == 1:
        return None
    if grid is not None and P > int(grid[STREAM_AXIS]):
        return (f"plane_tile {P} exceeds the stream extent "
                f"{int(grid[STREAM_AXIS])}: a sweep step would span more "
                "planes than the (shard-local) domain holds")
    return None


def effective_plane_tile(p: Program, requested: int,
                         grid: Sequence[int] | None = None) -> int:
    """The plane-unroll width one sweep step can actually honour: the
    requested ``plane_tile`` when :func:`plane_split_reason` allows it,
    else 1.  With ``grid=None`` the geometric check is deferred (buffer
    depths do not depend on it); callers that know the grid re-derive."""
    requested = max(1, int(requested))
    if requested == 1:
        return 1
    return 1 if plane_split_reason(p, requested, grid) is not None \
        else requested


def chained_halo(gh: GroupHalo, time_tile: int,
                 stream_sharded: bool = False) -> GroupHalo:
    """Input-halo reach of a T-chained region (paper: margins accumulate
    per chained step).

    Stage ``s+1`` trails stage ``s`` by the region ``lead`` along the
    stream axis, so the sweep front runs ``T x lead`` planes ahead of the
    final output plane.  On the non-stream axes every chained stage widens
    the working extent by one full halo step, so external inputs must
    arrive padded by ``T x`` the single-step halo on both sides.

    The **lo side of the stream axis** depends on where the sweep starts:
    locally (``stream_sharded=False``) it stays one window deep — the
    warm-up planes below the sweep are out of the global domain, masked to
    zero, and the clamped output overwrites them — but when the stream axis
    is domain-decomposed the planes below a shard's block belong to its
    neighbour and every chained stage needs them *exact*, so the lo-side
    ghost planes deepen by one per-step reach per stage (``T x`` the
    sharded per-step lo halo).  ``margins`` are kept per-stage by the
    lowering; carry/shard sizing only consumes ``input_halo``."""
    T = max(1, int(time_tile))
    if T == 1:
        return gh
    halo = np.array(gh.input_halo)
    halo[0, 1] *= T              # stream front: lead accumulates per stage
    halo[1:, :] *= T             # non-stream: one halo step per stage
    if stream_sharded:
        halo[0, 0] *= T          # sharded sweep start: exact ghosts per stage
    return GroupHalo(margins=gh.margins, input_halo=halo,
                     group_inputs=gh.group_inputs,
                     group_outputs=gh.group_outputs,
                     internal=gh.internal, group_coeffs=gh.group_coeffs)


# --------------------------------------------------------------------------
# Stream-aware halo inference
# --------------------------------------------------------------------------


def stream_halo(p: Program, region: Sequence[int],
                stream_sharded: bool = False) -> GroupHalo:
    """Margins and window halo for one *stream* region.

    Differs from :func:`~repro_torch.core.passes.infer_halo` exactly where the
    shift registers change the cost model: along the stream axis, producers
    get **no** evaluation margin (consumers read past planes out of the ring
    buffer instead of forcing recompute) and the window halo is the raw
    access reach (every op evaluates at the same output plane).  The
    non-stream axes keep the block schedule's margin propagation.

    With ``stream_sharded`` (the stream axis is domain-decomposed across a
    mesh) the lo-side stream halo additionally propagates through in-region
    producer chains: a ring-buffered temp read ``k`` planes back makes its
    producer's value load-bearing ``k`` planes below the output plane, and
    that producer's own external reads reach further still.  Locally this
    is unobservable — warm-up planes below the sweep are out of the global
    domain and masked to zero — but a shard whose block starts mid-domain
    must fetch *exact* neighbour planes deep enough that every ring warms
    up with true values before the first owned output plane.
    """
    region = list(region)
    gset = set(region)
    ndim = p.ndim
    producer = {p.ops[i].out: i for i in region}

    consumed_later = set()
    for j, op in enumerate(p.ops):
        if j in gset:
            continue
        for a in op.accesses():
            consumed_later.add(a.field)
    group_outputs, internal = [], []
    for i in region:
        out = p.ops[i].out
        if p.fields[out].role == FieldRole.OUTPUT or out in consumed_later:
            group_outputs.append(out)
        else:
            internal.append(out)

    margins = {i: _zeros(ndim) for i in region}
    # stream-axis lo margin per op: how many planes *below* the output
    # plane an op's value must be exact for in-region consumers (ring
    # back-references accumulate through producer chains).  Stays zero
    # unless the stream axis is sharded — locally the warm-up planes are
    # out-of-domain and masked, so no extra fetch is needed.
    smargin = {i: 0 for i in region}
    for i in reversed(region):
        m = margins[i]
        for a in p.ops[i].accesses():
            if a.field in producer and producer[a.field] in gset:
                pi = producer[a.field]
                if pi >= i:
                    raise ValueError("dependency violates program order")
                o0 = int(a.offset[STREAM_AXIS])
                if o0 > 0:
                    raise ValueError(
                        f"region {region} not stream-legal: {a.field!r} read "
                        f"at stream offset +{o0}; run legalize_stream_groups")
                if stream_sharded:
                    smargin[pi] = max(smargin[pi], smargin[i] - o0)
                need = _zeros(ndim)
                for ax in range(1, ndim):
                    o = a.offset[ax]
                    need[ax, 0] = max(0, m[ax, 0] - o)
                    need[ax, 1] = max(0, m[ax, 1] + o)
                margins[pi] = np.maximum(margins[pi], need)

    halo = _zeros(ndim)
    group_inputs: list = []
    group_coeffs: list = []
    for i in region:
        op = p.ops[i]
        m = margins[i]
        # a sharded sweep starts ``smargin`` planes below the shard so the
        # rings warm up with true values, also for an op that reads no
        # field (a temp fed by a coefficient or a scalar alone)
        halo[0, 0] = max(halo[0, 0], smargin[i])
        for a in op.accesses():
            if a.field in producer:
                continue
            if a.field not in group_inputs:
                group_inputs.append(a.field)
            o0 = int(a.offset[STREAM_AXIS])
            halo[0, 0] = max(halo[0, 0], smargin[i] - o0)
            halo[0, 1] = max(halo[0, 1], o0)
            for ax in range(1, ndim):
                o = a.offset[ax]
                halo[ax, 0] = max(halo[ax, 0], m[ax, 0] - o)
                halo[ax, 1] = max(halo[ax, 1], m[ax, 1] + o)
        for c in op.coeff_refs():
            ax = p.coeffs[c.coeff]
            if c.coeff not in group_coeffs:
                group_coeffs.append(c.coeff)
            if ax == STREAM_AXIS:
                halo[0, 0] = max(halo[0, 0], smargin[i] - c.offset)
                halo[0, 1] = max(halo[0, 1], c.offset)
            else:
                halo[ax, 0] = max(halo[ax, 0], m[ax, 0] - c.offset)
                halo[ax, 1] = max(halo[ax, 1], m[ax, 1] + c.offset)
    return GroupHalo(margins=margins, input_halo=halo,
                     group_inputs=group_inputs, group_outputs=group_outputs,
                     internal=internal, group_coeffs=group_coeffs)


# --------------------------------------------------------------------------
# Buffer sizing + graph construction
# --------------------------------------------------------------------------


def window_depths(p: Program, region: Sequence[int], gh: GroupHalo
                  ) -> tuple:
    """Per-field shift-register depths and temp ring depths for a region.

    An input field's window must hold every plane between its deepest
    back-reference and the stream front (which runs ``lead`` planes ahead
    of the output plane so the *widest* forward reach in the region is
    resident): ``depth = lo + lead + 1``.  A temp read at past planes keeps
    ``1 + max back-reference`` planes in its ring."""
    region = list(region)
    produced = {p.ops[i].out for i in region}
    lead = int(gh.input_halo[STREAM_AXIS, 1])
    lo_reach = {f: 0 for f in gh.group_inputs}
    ring_back: dict = {}
    for i in region:
        for a in p.ops[i].accesses():
            o0 = int(a.offset[STREAM_AXIS])
            if a.field in produced:
                if o0 < 0:
                    ring_back[a.field] = max(ring_back.get(a.field, 0), -o0)
            else:
                lo_reach[a.field] = max(lo_reach[a.field], -o0)
    depths = {f: lo_reach[f] + lead + 1 for f in gh.group_inputs}
    rings = {t: back + 1 for t, back in ring_back.items()}
    return depths, rings


def _regions_legal(p: Program, regions) -> bool:
    """Are these cached region splits still stream-legal for ``p``?  A
    cached :class:`~repro_torch.core.schedule.StreamSpec` may come from a plan
    legalised against a program with different boundaries."""
    for region in regions:
        produced: set = set()
        for i in region:
            if produced and stream_split_reason(p, produced, i) is not None:
                return False
            produced.add(p.ops[i].out)
    return True


def lower_to_dataflow(p: Program, plan, grid: Sequence[int] | None = None,
                      stream_sharded: bool = False) -> StreamGraph:
    """Lower validated stencil IR + plan fuse groups to the dataflow layer.

    ``plan`` only contributes its ``groups`` (and, when present, a cached
    ``StreamSpec`` whose legalised regions are reused — after re-checking
    they are still legal for this program — so a plan deserialised from
    the tuner cache lowers identically).  ``grid`` is optional and only
    used for sanity checks — buffer depths derive from access offsets
    alone.

    ``stream_sharded`` marks the stream axis as domain-decomposed across a
    mesh: region input halos then carry the deepened lo-side ghost-plane
    reach (see :func:`stream_halo` / :func:`chained_halo`).  The legalised
    region split, window depths and ring depths are *identical* either way
    — a :class:`~repro_torch.core.schedule.StreamSpec` cached from a local tune
    reuses cleanly under a mesh and vice versa.
    """
    if p.ndim < 2:
        raise ValueError(
            "schedule='stream' needs ndim >= 2: streaming the only axis "
            "would leave nothing vectorised inside a plane")
    spec = getattr(plan, "stream", None)
    if spec is not None and spec.regions \
            and _regions_legal(p, spec.regions):
        region_ops = [list(r) for r in spec.regions]
    else:
        # no cached geometry — or the cached split is illegal for *this*
        # program (e.g. the plan was legalised under zero boundaries and
        # is now compiled with ``boundary="periodic"``, where a temp's
        # negative stream offset may no longer ride a ring): re-legalise
        # from the fuse groups rather than silently mis-streaming
        region_ops = legalize_stream_groups(p, plan.groups)

    regions = []
    for ops in region_ops:
        gh = stream_halo(p, ops, stream_sharded=stream_sharded)
        depths, rings = window_depths(p, ops, gh)
        nodes: list = []
        for f in gh.group_inputs:
            nodes.append(Load(field=f))
            nodes.append(Window(field=f, depth=depths[f],
                                lo=depths[f] - 1 - int(gh.input_halo[0, 1]),
                                hi=int(gh.input_halo[0, 1])))
        for i in ops:
            nodes.append(Compute(op=i, out=p.ops[i].out,
                                 ring=rings.get(p.ops[i].out, 0)))
        for f in gh.group_outputs:
            nodes.append(Store(field=f))
        regions.append(StreamRegion(ops=list(ops), nodes=nodes, halo=gh,
                                    depths=depths, rings=rings,
                                    lead=int(gh.input_halo[0, 1])))

    if grid is not None:
        grid = tuple(int(g) for g in grid)
        if len(grid) != p.ndim:
            raise ValueError(f"grid rank {len(grid)} != ndim {p.ndim}")
    req_t = max(1, int(getattr(plan, "time_tile", 1)))
    req_p = max(1, int(getattr(plan, "plane_tile", 1)))
    eff = effective_time_tile(p, region_ops, req_t)
    eff_p = effective_plane_tile(p, req_p, grid)
    # demotions are *events*, not silent field values: the ambient tracer
    # (a no-op unless tracing is on) records why the request shrank, with
    # the same structured reason the compile-time warning carries
    tracer = current_tracer()
    if tracer.enabled:
        if eff < req_t:
            tracer.emit(ChainDemoted(
                program=p.name, requested=req_t, effective=eff,
                reason=chain_split_reason(p, region_ops) or ""))
        if eff_p < req_p:
            tracer.emit(PlaneDemoted(
                program=p.name, requested=req_p, effective=eff_p,
                reason=plane_split_reason(p, req_p, grid) or ""))
    return StreamGraph(program=p.name, axis=STREAM_AXIS, regions=regions,
                       time_tile=eff, plane_tile=eff_p,
                       stream_sharded=stream_sharded)
