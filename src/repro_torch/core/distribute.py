"""Distributed stencil execution: domain decomposition + halo exchange (the
port of ``repro.core.distribute``).

The cluster analogue of the paper's step 9 ("one AXI bundle / HBM bank per
field"): every shard owns a contiguous sub-domain in its device's memory,
and the inter-bank traffic becomes halo exchange between shard tensors.

The reference runs one program under ``shard_map`` and moves halos by
``lax.ppermute``.  The port keeps its single-controller shape: one process
holds a :class:`~repro_torch.dist.sharding.Mesh` of ``torch.device``\\ s,
each shard of a field is a tensor on its device, and the orchestrators
below run every shard's kernels in turn.  A halo slab moves to its
neighbour's device by ``Tensor.to(device, non_blocking=True)`` (peer to
peer between cards, no copy at all within one device), which torch orders
against both devices' current streams.

* :func:`lower_sharded` — one program step.  Per fuse group, *group-major*:
  every group input of every shard is halo-exchanged axis by axis (the slab
  sent along axis k is cut from the neighbour's buffer already padded on
  axes < k, so corners are correct for diagonal offsets), then the group
  runs on every shard's padded block with the shard origin, so the
  global-domain mask is exact.  (Shard-major order would let a shard's
  later group read halos of a neighbour's earlier group not yet computed;
  the reference's ``shard_map`` hides that ordering.)

* :func:`lower_sharded_time_loop` — the fused time loop.  Each shard keeps
  one pre-padded buffer per persistent field on its device for all N
  steps; each step refreshes the halo slabs by exchange straight from the
  buffers, runs the fuse groups against them (the kernels read their
  windows via ``input_pad``) and writes the new interiors back.  One
  exchange per field per step serves every consuming group, because the
  carry is padded to the worst group's halo (``TimeLoopSpec.field_pad``).

Boundaries follow each field's declaration (:mod:`repro_torch.core.boundary`):
``"zero"`` rings leave the edge shard's halo zero-filled
(:func:`~repro_torch.core.boundary.ring_perms`), ``"periodic"`` closes the
ring (and wraps locally on unsharded axes).

Every backend lowers here: ``cuda`` runs the generated kernels (block or
stream schedule) on local blocks; the torch backends route temp accesses
through :func:`~repro_torch.core.lower_torch.lower`'s ``shift_fn`` hook
(exchange shifts, all shards advanced op by op in lock step) and slice
replicated coefficient arrays at the shard origin via ``coeff_fn``.  A
degenerate 1x..x1 mesh runs the local lowerings on its device, so its
results are bit-equal to the local compile.

Each executable takes global tensors, scatters them to the shards once and
returns global tensors gathered onto ``mesh.devices.flat[0]``.  The kernels
launch on each shard's device; their C entries set the dynamic
shared-memory attribute once a process, so a kernel above 48 KB of shared
memory launches on the first card it meets (a mesh of several cards is
what a four-card run would exercise).

:func:`make_sharded_executor` — the original standalone entry point — is
deprecated; it forwards to ``compile_program(..., mesh=...)``.
"""

from __future__ import annotations

import contextlib
import itertools
import warnings
from typing import Mapping, Sequence

import torch

from ..kernels.stencil3d import bind, build_group_call
from ..kernels.stream3d import StreamCall
from ..obs.trace import current_tracer
from . import boundary as bc
from .dataflow import STREAM_AXIS, lower_to_dataflow
from .ir import Program
from .lower_kernel import DTYPES, scalar_vector, update_scalars
from .lower_stream import trace_update
from .lower_torch import lower_steps, write_back
from .schedule import DataflowPlan, ShardSpec, TimeLoopSpec, adapt_update

#: bytes of halo slabs moved between shards along sharded axes (zero and
#: wrap slabs made in place excluded), counted like the kernels' launches
exchanged_bytes = 0


# --------------------------------------------------------------------------
# shards and the halo exchange
# --------------------------------------------------------------------------

class _Shards:
    """The shards of a :class:`ShardSpec` on a mesh: each block index (one
    entry per grid axis, 0 on unsharded axes) with its global origin and
    its device.  Mesh axes no grid axis is sharded over hold replicas; the
    port runs the replica at coordinate 0 of such axes."""

    def __init__(self, shard: ShardSpec, mesh):
        self.spec = shard
        self.ndim = len(shard.mesh_axes)
        counts = [shard.axis_size(ax) for ax in range(self.ndim)]
        self.index = list(itertools.product(*(range(n) for n in counts)))
        axis_of = {a: ax for ax, a in enumerate(shard.mesh_axes)
                   if a is not None}
        self.origin, self.device = {}, {}
        for idx in self.index:
            coord = tuple(idx[axis_of[a]] if a in axis_of else 0
                          for a in mesh.axis_names)
            self.device[idx] = torch.device(mesh.devices[coord])
            self.origin[idx] = tuple(int(i) * int(n) for i, n
                                     in zip(idx, shard.local_grid))
        self.home = torch.device(mesh.devices.flat[0])
        self.devices = list(dict.fromkeys(self.device.values()))

    def scatter(self, x: torch.Tensor, lead: int) -> dict:
        """Each shard's block of a global tensor, on its device (a view
        where the device is the tensor's)."""
        loc = self.spec.local_grid
        out = {}
        for idx in self.index:
            sl = (slice(None),) * lead + tuple(
                slice(i * n, (i + 1) * n) for i, n in zip(idx, loc))
            out[idx] = _to(x[sl], self.device[idx])
        return out

    def gather(self, blocks: Mapping, lead: int) -> torch.Tensor:
        """The global tensor of the shards' blocks, on the mesh's first
        device."""
        parts = {idx: _to(b, self.home) for idx, b in blocks.items()}
        for ax in reversed(range(self.ndim)):
            merged: dict = {}
            for key in sorted(parts):
                merged.setdefault(key[:ax], []).append(parts[key])
            parts = {k: torch.cat(v, dim=lead + ax) if len(v) > 1 else v[0]
                     for k, v in merged.items()}
        return parts[()]

    def on(self, idx):
        """Context making the shard's device current (launches and their
        streams land on it)."""
        dev = self.device[idx]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())


def _to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``; asynchronous between cards (ordered against both
    devices' current streams), synchronous when the host receives it."""
    device = torch.device(device)
    if x.device == device:
        return x
    return x.to(device, non_blocking=device.type == "cuda")


def _exchange_axis(blocks: Mapping, ax: int, lo: int, hi: int, align: int,
                   n: int, periodic: bool) -> dict:
    """Pad every shard's block along grid axis ``ax`` with its neighbours'
    halo slabs (``n > 1`` shards along the axis; the ring closed iff
    periodic), a local wrap (unsharded, periodic) or zeros, plus a zero
    alignment slab of ``align`` on the hi side."""
    lo, hi, align = int(lo), int(hi), int(align)
    if lo == 0 and hi == 0 and align == 0:
        return dict(blocks)
    sharded = n > 1
    # shard j's lo halo comes from the shard ring_perms(+1) sends to j,
    # its hi halo from the one ring_perms(-1) sends to j
    from_lo = {d: s for s, d in bc.ring_perms(n, +1, periodic)}
    from_hi = {d: s for s, d in bc.ring_perms(n, -1, periodic)}
    out = {}
    for idx, x in blocks.items():
        ndim = len(idx)
        dim = x.ndim - ndim + ax
        size = x.shape[dim]

        def zeros(k, x=x, dim=dim):
            shp = list(x.shape)
            shp[dim] = k
            return x.new_zeros(shp)

        def slab(src, start, k, x=x, dim=dim):
            global exchanged_bytes
            if src is None:
                return zeros(k)
            nb = blocks[idx[:ax] + (src,) + idx[ax + 1:]]
            piece = nb.narrow(dim, start, k)
            exchanged_bytes += piece.numel() * piece.element_size()
            return _to(piece, x.device)

        pieces = []
        if lo > 0:
            if sharded:
                pieces.append(slab(from_lo.get(idx[ax]), size - lo, lo))
            elif periodic:
                pieces.append(x.narrow(dim, size - lo, lo))
            else:
                pieces.append(zeros(lo))
        pieces.append(x)
        if hi > 0:
            if sharded:
                pieces.append(slab(from_hi.get(idx[ax]), 0, hi))
            elif periodic:
                pieces.append(x.narrow(dim, 0, hi))
            else:
                pieces.append(zeros(hi))
        if align > 0:
            pieces.append(zeros(align))
        out[idx] = torch.cat(pieces, dim=dim)
    return out


def halo_exchange_pad(blocks: Mapping, lo: Sequence[int], hi: Sequence[int],
                      align_hi: Sequence[int], mesh_axes: Sequence,
                      axis_sizes: Mapping | None = None,
                      periodic: bool = False) -> dict:
    """Pad every shard's local block with neighbour halos (sharded axes),
    wraparound (periodic unsharded axes) or zeros, and a zero alignment
    slab.

    ``blocks`` maps each shard's block index (one entry per grid axis, 0
    on unsharded ones) to its tensor; leading axes before the grid axes
    (a serving batch's) are not padded.  ``axis_sizes`` maps mesh-axis
    name -> size.  The axes go in order over *all* shards, so the slab
    sent along axis k carries the halos of axes < k: corners are exact."""
    axis_sizes = axis_sizes or {}
    out = dict(blocks)
    for ax in range(len(lo)):
        a = mesh_axes[ax] if ax < len(mesh_axes) else None
        n = 1 if a is None else int(axis_sizes[a])
        al = int(align_hi[ax]) if ax < len(align_hi) else 0
        out = _exchange_axis(out, ax, int(lo[ax]), int(hi[ax]), al, n,
                             periodic)
    return out


# --------------------------------------------------------------------------
# plumbing shared by the single-step and fused-loop lowerings
# --------------------------------------------------------------------------

def _degenerate(shard: ShardSpec) -> bool:
    """True when no grid axis is actually sharded (a 1x..x1 mesh): the
    executable is then the local lowering on the mesh's device, so its
    results are bit-equal to the local compile's."""
    return all(shard.axis_size(ax) == 1 for ax in range(len(shard.mesh_axes)))


def _local(p: Program, plan: DataflowPlan, grid, mesh, spec=None,
           update=None, graph=None):
    """The local pad path of a degenerate mesh: the lowering
    ``compile_program`` picks without a mesh, on the mesh's device."""
    from . import lower_kernel, lower_stream, lower_torch
    from .pipeline import _on_device       # pipeline imports this module
    device = torch.device(mesh.devices.flat[0])
    mode = plan.backend.removeprefix("torch_")
    if spec is not None:
        if plan.schedule == "stream":
            return lower_stream.lower_time_loop(p, plan, grid, spec, update,
                                                device, graph=graph)
        if plan.backend == "cuda":
            return lower_kernel.lower_time_loop(p, plan, grid, spec, update,
                                                device)
        return _on_device(lower_torch.lower_time_loop(p, mode, spec, update),
                          p, plan.dtype, device)
    if plan.schedule == "stream":
        return lower_stream.lower(p, plan, grid, device, graph=graph)
    if plan.backend == "cuda":
        return lower_kernel.lower(p, plan, grid, device)
    return _on_device(lower_torch.lower(p, mode), p, plan.dtype, device)


def _coeff_reach(p: Program) -> dict:
    """coeff name -> (lo, hi) extension covering every CoeffRef offset."""
    reach = {c: [0, 0] for c in p.coeffs}
    for op in p.ops:
        for c in op.coeff_refs():
            reach[c.coeff][0] = max(reach[c.coeff][0], -int(c.offset))
            reach[c.coeff][1] = max(reach[c.coeff][1], int(c.offset))
    return reach


def _kernel_reach(calls, p: Program) -> dict:
    """coeff name -> (lo, hi) extension covering every call's window."""
    reach = {c: [0, 0] for c in p.coeffs}
    for call in calls:
        for c in call.group_coeffs:
            ax = call.coeff_axis[c]
            reach[c][0] = max(reach[c][0], call.pad_lo[ax])
            reach[c][1] = max(reach[c][1], call.pad_hi[ax])
    return reach


def _host_coeffs(p: Program, coeffs: Mapping, dtype, reach: dict,
                 devices) -> dict:
    """Replicated coefficient arrays, pre-extended by ``reach`` so any shard
    can slice its piece ('small data' lives on every device, paper step 8):
    device -> {coeff: tensor}."""
    cmode = bc.coeff_mode(p)
    ext = {c: bc.pad_coeff(torch.as_tensor(coeffs[c], dtype=dtype,
                                           device=devices[0]),
                           reach[c][0], reach[c][1], cmode)
           for c in p.coeffs}
    return {d: {c: _to(v, d) for c, v in ext.items()} for d in devices}


def _coeff_windows(calls, coeffs: Mapping, origin, shard: ShardSpec,
                   reach: dict) -> list:
    """Per-call local coefficient windows, sliced at the shard origin."""
    out = []
    for call in calls:
        pc = {}
        for c in call.group_coeffs:
            ax = call.coeff_axis[c]
            start = origin[ax] + reach[c][0] - call.pad_lo[ax]
            size = shard.local_grid[ax] + call.pad_lo[ax] + call.pad_hi[ax]
            pc[c] = coeffs[c].narrow(-1, start, size).contiguous()
        out.append(pc)
    return out


def _stream_graph(p: Program, plan: DataflowPlan, shard: ShardSpec, graph):
    """The plan's dataflow graph, lowered for this shard's topology.

    A sharded stream axis needs *exact* neighbour ghost planes (the region
    halos carry the ring-chain-propagated lo reach), so a graph built
    without the flag must not drive a sharded sweep — rebuild unless the
    caller handed one down from the pipeline."""
    if plan.schedule != "stream":
        return None
    ss = shard.axis_size(STREAM_AXIS) > 1
    if graph is None or bool(graph.stream_sharded) != ss:
        graph = lower_to_dataflow(p, plan, shard.local_grid,
                                  stream_sharded=ss)
    return graph


def _kernel_calls(p: Program, plan: DataflowPlan, local_grid, global_grid,
                  dtype, graph, time_tile: int = 1, update=None) -> list:
    """The plan's kernel calls on the shard-local block.

    Block and stream kernels expose the same geometry contract
    (``group_inputs``/``halo_lo``/``input_pad``/``origin=``), so the
    orchestrators below drive either schedule alike; a stream sweep also
    chains ``time_tile`` steps when the fused loop's ``update`` rule runs
    in-kernel, and advances the graph's effective ``plane_tile`` planes a
    step (demoted against the *shard-local* stream extent)."""
    if plan.schedule != "stream":
        return [build_group_call(p, grp, plan.block, local_grid, dtype=dtype,
                                 global_extent=global_grid)
                for grp in plan.groups]
    kw = {}
    if time_tile > 1:
        region = graph.regions[0]   # chain legality implies one region
        outs = [p.ops[i].out for i in region.ops
                if p.ops[i].out in set(region.halo.group_outputs)]
        exprs, reason = trace_update(p, update, region.halo.group_inputs,
                                     outs)
        if exprs is None:
            raise ValueError(f"time_tile={time_tile} needs an update rule "
                             f"that traces into the kernel: {reason}")
        kw = dict(time_tile=time_tile, update=update, update_exprs=exprs)
    return [StreamCall(p, region, local_grid, dtype=dtype,
                       global_extent=global_grid, plane_tile=graph.plane_tile,
                       stream_sharded=graph.stream_sharded, **kw)
            for region in graph.regions]


def _announce(p: Program, mode: str, backend: str, mesh, shard: ShardSpec,
              **extra) -> None:
    tracer = current_tracer()
    if tracer.enabled:
        tracer.event("ShardLowered", program=p.name, mode=mode,
                     backend=backend, mesh=dict(mesh.shape),
                     local_grid="x".join(str(g) for g in shard.local_grid),
                     **extra)


def _exchange(blocks: Mapping, lo, hi, align_hi, shard: ShardSpec,
              periodic: bool, field: str) -> dict:
    """One field's halo exchange inside a ``distribute.exchange`` span;
    the results are contiguous, as the kernels read them."""
    with current_tracer().span("distribute.exchange", field=field):
        out = halo_exchange_pad(blocks, lo, hi, align_hi, shard.mesh_axes,
                                shard.axis_sizes, periodic=periodic)
    return {idx: x.contiguous() for idx, x in out.items()}


def _scalars_on(scalars: Mapping, device) -> dict:
    """The scalars an update rule sees on a shard: as given, tensors moved
    to the shard's device."""
    return {s: _to(v, device) if isinstance(v, torch.Tensor) else v
            for s, v in scalars.items()}


def _torch_shards(p: Program, mode: str, shards: _Shards, prepad, coeff_dev,
                  reach):
    """Run the torch lowering on every shard in lock step, op by op: a
    shard's ``shift_fn`` finds every shard's value of the field it shifts
    (all of them past the op that produced it), exchanges it across the
    mesh once per field and offset, and keeps its own piece.  Returns
    ``run(fields_by_shard, scalars) -> outputs_by_shard``."""
    shard, ndim = shards.spec, p.ndim

    def run(fields_by_shard: Mapping, scalars: Mapping) -> dict:
        envs: dict = {}
        shifted: dict = {}

        def shift_all(f, offset, kind):
            cur = {idx: envs[idx][f] for idx in shards.index}
            for ax in range(ndim):
                o = int(offset[ax])
                if o == 0:
                    continue
                n_loc = shard.local_grid[ax]
                if abs(o) > n_loc:
                    raise ValueError(
                        f"offset {o} on axis {ax} exceeds the local extent "
                        f"{n_loc} (halo exchange is single-hop)")
                lo, hi = max(0, -o), max(0, o)
                with current_tracer().span("distribute.exchange", field=f):
                    xp = _exchange_axis(cur, ax, lo, hi, 0,
                                        shard.axis_size(ax),
                                        kind == "periodic")
                cur = {idx: x.narrow(x.ndim - ndim + ax, lo + o, n_loc)
                       for idx, x in xp.items()}
            return cur

        def make_hooks(idx):
            origin = shards.origin[idx]

            def shift(x, offset, kind):
                f = next(k for k, v in envs[idx].items() if v is x)
                key = (f, tuple(int(o) for o in offset))
                if key not in shifted:
                    shifted[key] = shift_all(f, offset, kind)
                return shifted[key][idx]

            def coeff(cref, coeffs):
                # replicated and pre-extended by ``reach``: the shard
                # slices its window at the global origin
                ax = p.coeffs[cref.coeff]
                start = origin[ax] + reach[cref.coeff][0] + int(cref.offset)
                v = coeffs[cref.coeff].narrow(-1, start, shard.local_grid[ax])
                shape = [1] * ndim
                shape[ax] = shard.local_grid[ax]
                return v.reshape(shape)

            return shift, coeff, origin

        gens = {}
        for idx in shards.index:
            shift, coeff, origin = make_hooks(idx)
            dev = shards.device[idx]
            gens[idx] = lower_steps(p, mode, prepad, shift, coeff, origin)(
                fields_by_shard[idx], scalars, coeff_dev[dev])
        done: dict = {}
        while len(done) < len(gens):
            for idx, gen in gens.items():
                if idx in done:
                    continue
                with shards.on(idx):
                    try:
                        envs[idx] = next(gen)
                    except StopIteration as stop:
                        done[idx] = stop.value
        return done

    return run


# --------------------------------------------------------------------------
# one program step
# --------------------------------------------------------------------------

def lower_sharded(p: Program, plan: DataflowPlan, global_grid,
                  shard: ShardSpec, mesh, graph=None):
    """Return fn(fields, scalars, coeffs) running one program step over the
    mesh: global tensors in, global outputs out (on the mesh's first
    device).

    Schedule-agnostic: ``plan.schedule`` picks the block-tiled group
    kernels or the plane-sweeping stream kernels per shard (``graph``
    optionally hands down the pipeline's already-lowered dataflow
    graph).  The ``cuda`` backend's ``fn`` also takes ``batched=True``
    (fields ``(B, *grid)``), as the local orchestrator does."""
    global_grid = tuple(int(g) for g in global_grid)
    backend = plan.backend
    _announce(p, "single", backend, mesh, shard)
    if _degenerate(shard):
        return _local(p, plan, global_grid, mesh, graph=graph)
    dtype = DTYPES[plan.dtype]
    bnd = p.boundaries()
    shards = _Shards(shard, mesh)
    out_names = p.output_fields()

    if backend == "cuda":
        graph = _stream_graph(p, plan, shard, graph)
        calls = _kernel_calls(p, plan, shard.local_grid, global_grid, dtype,
                              graph)
        bind(calls)
        reach = _kernel_reach(calls, p)

        def run(fields: Mapping, scalars: Mapping | None = None,
                coeffs: Mapping | None = None, *, batched: bool = False):
            scalars, coeffs = scalars or {}, coeffs or {}
            lead = int(batched)
            blocks = {f: shards.scatter(torch.as_tensor(
                fields[f], dtype=dtype, device=shards.home), lead)
                for f in p.input_fields()}
            svec = {d: scalar_vector(p, scalars, d, batched, fields)
                    for d in shards.devices}
            cdev = _host_coeffs(p, coeffs, dtype, reach, shards.devices)
            pcs = {idx: _coeff_windows(calls, cdev[shards.device[idx]],
                                       shards.origin[idx], shard, reach)
                   for idx in shards.index}
            env = {idx: {} for idx in shards.index}
            outs = {idx: {} for idx in shards.index}
            for k, call in enumerate(calls):       # group-major
                padded = {}
                for f in call.group_inputs:
                    src = {idx: env[idx][f] if f in env[idx]
                           else blocks[f][idx] for idx in shards.index}
                    padded[f] = _exchange(src, call.halo_lo, call.halo_hi,
                                          call.align_hi, shard,
                                          bnd[f] == "periodic", f)
                for idx in shards.index:
                    with shards.on(idx):
                        res = call({f: padded[f][idx]
                                    for f in call.group_inputs},
                                   svec[shards.device[idx]], pcs[idx][k],
                                   origin=shards.origin[idx],
                                   device=shards.device[idx])
                    env[idx].update(res)
                    outs[idx].update({f: v for f, v in res.items()
                                      if f in out_names})
            return {f: shards.gather({idx: outs[idx][f]
                                      for idx in shards.index}, lead)
                    for f in out_names}

        run.calls = calls
        return run

    if backend not in ("torch_fused", "torch_naive"):
        raise ValueError(f"unknown backend {backend!r}")
    mode = backend.removeprefix("torch_")
    reach = _coeff_reach(p)

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None):
        scalars, coeffs = scalars or {}, coeffs or {}
        blocks = {f: shards.scatter(torch.as_tensor(
            fields[f], dtype=dtype, device=shards.home), 0)
            for f in p.input_fields()}
        cdev = _host_coeffs(p, coeffs, dtype, reach, shards.devices)
        step = _torch_shards(p, mode, shards, None, cdev, reach)
        res = step({idx: {f: blocks[f][idx] for f in blocks}
                    for idx in shards.index}, scalars)
        return {f: shards.gather({idx: res[idx][f] for idx in shards.index},
                                 0)
                for f in out_names}

    run.calls = []
    return run


# --------------------------------------------------------------------------
# the fused time loop (carry-resident halo exchange)
# --------------------------------------------------------------------------

def lower_sharded_time_loop(p: Program, plan: DataflowPlan, global_grid,
                            spec: TimeLoopSpec, update, mesh, graph=None):
    """Return fn(fields, scalars, coeffs) -> final fields after
    ``spec.steps`` iterations over the mesh.

    Each shard's carry holds one local buffer per persistent field, padded
    to the worst group's halo, on its device for all N steps.  A step:

        refresh every field's halo slabs from the carry interiors
            (neighbour slabs / local wrap / zeros, axis by axis over all
            shards, so corners are exact)
        run the plan's kernels, group by group over all shards, against
            the refreshed buffers
        apply ``update`` on every shard; write the new interiors back

    With an effective ``time_tile = T > 1`` on the dataflow graph, each
    iteration runs ONE chained sweep a shard advancing T steps (all T
    updates in-kernel; the carry padding covers the chain's accumulated
    halos, so still one exchange per field per *chain*), the loop runs
    ``spec.steps // T`` iterations, and a ``steps % T`` remainder runs once
    after it through a shallower chain.  The ``cuda`` backend's ``fn``
    also takes ``batched=True``."""
    shard = spec.shard
    if shard is None:
        raise ValueError("spec has no ShardSpec; use the local lowerings")
    update = adapt_update(update)
    global_grid = tuple(int(g) for g in global_grid)
    backend = plan.backend
    _announce(p, "loop", backend, mesh, shard, steps=int(spec.steps))
    if _degenerate(shard):
        return _local(p, plan, global_grid, mesh, spec=spec, update=update,
                      graph=graph)
    ndim = p.ndim
    dtype = DTYPES[plan.dtype]
    bnd = p.boundaries()
    shards = _Shards(shard, mesh)
    local_grid = shard.local_grid
    fpad = spec.field_pad
    align = spec.align_hi or (0,) * ndim
    persistent = list(spec.persistent)
    interior = {f: tuple(slice(int(fpad[f][a, 0]),
                               int(fpad[f][a, 0]) + local_grid[a])
                         for a in range(ndim))
                for f in persistent}
    carry_pads = {f: ([int(fpad[f][a, 0]) for a in range(ndim)],
                      [int(fpad[f][a, 1]) for a in range(ndim)])
                  for f in persistent}

    def needs_refresh(f) -> bool:
        # a field's carry halos go stale each step only if they hold
        # wraparound values (periodic) or neighbour data (sharded axis);
        # zero halos on unsharded axes never change
        for a in range(ndim):
            lo = int(fpad[f][a, 0])
            hi = int(fpad[f][a, 1]) - int(align[a])
            if lo == 0 and hi == 0:
                continue
            if bnd[f] == "periodic" or shard.axis_size(a) > 1:
                return True
        return False

    refreshed = {f for f in persistent if needs_refresh(f)}

    def refresh(carry: dict, lead: int) -> dict:
        """Every field's halo slabs rebuilt from the carry interiors."""
        fresh = {}
        for f in persistent:
            if f not in refreshed:
                fresh[f] = carry[f]
                continue
            inner = (slice(None),) * lead + interior[f]
            fresh[f] = _exchange(
                {idx: c[inner] for idx, c in carry[f].items()},
                fpad[f][:, 0],
                [int(fpad[f][a, 1]) - int(align[a]) for a in range(ndim)],
                align, shard, bnd[f] == "periodic", f)
        return fresh

    def zero_pad(f, x):
        lo, hi = carry_pads[f]
        return bc.pad_field(x, lo, hi, "zero").contiguous()

    chain = 1
    calls, epilogue = [], []
    if backend == "cuda":
        graph = _stream_graph(p, plan, shard, graph)
        T = int(graph.time_tile) if graph is not None else 1
        if T > 1:
            chain = T
            calls = _kernel_calls(p, plan, local_grid, global_grid, dtype,
                                  graph, time_tile=T, update=update)
            rem = int(spec.steps) % T
            if rem:
                epilogue = _kernel_calls(p, plan, local_grid, global_grid,
                                         dtype, graph, time_tile=rem,
                                         update=update)
        else:
            calls = _kernel_calls(p, plan, local_grid, global_grid, dtype,
                                  graph)
        bind(calls + epilogue)
        reach = _kernel_reach(calls + epilogue, p)
    elif backend in ("torch_fused", "torch_naive"):
        reach = _coeff_reach(p)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None, *, batched: bool = False):
        scalars, coeffs = scalars or {}, coeffs or {}
        if batched and backend != "cuda":
            raise ValueError("the torch backends run a batch unrolled "
                             "(pipeline.batched_executable)")
        lead = int(batched)
        inner = {f: (slice(None),) * lead + interior[f] for f in persistent}
        # initial carry: zero-padded; the halos are refreshed before the
        # first compute
        carry = {f: {idx: zero_pad(f, b) for idx, b in shards.scatter(
            torch.as_tensor(fields[f], dtype=dtype, device=shards.home),
            lead).items()} for f in persistent}
        cdev = _host_coeffs(p, coeffs, dtype, reach, shards.devices)
        sdev = {d: (update_scalars(p, scalars, True, d) if batched
                    else _scalars_on(scalars, d)) for d in shards.devices}
        if backend == "cuda":
            svec = {d: scalar_vector(p, scalars, d, batched, fields)
                    for d in shards.devices}
            pcs = {idx: _coeff_windows(calls + epilogue,
                                       cdev[shards.device[idx]],
                                       shards.origin[idx], shard, reach)
                   for idx in shards.index}
        else:
            step = _torch_shards(p, backend.removeprefix("torch_"), shards,
                                 fpad, cdev, reach)

        def kernels(fresh, calls_, first):
            """Every shard's outputs of one step (or its new fields, for a
            chained sweep) from the refreshed buffers, group-major."""
            if getattr(calls_[0], "returns_fields", False):
                call = calls_[0]
                res = {}
                for idx in shards.index:
                    with shards.on(idx):
                        res[idx] = call(
                            {f: fresh[f][idx] for f in call.group_inputs},
                            svec[shards.device[idx]], pcs[idx][first],
                            input_pad={f: fpad[f] for f in call.group_inputs},
                            origin=shards.origin[idx],
                            device=shards.device[idx])
                return res
            env = {idx: {} for idx in shards.index}
            outs = {idx: {} for idx in shards.index}
            for k, call in enumerate(calls_):
                padded, ipad = {}, {}
                for f in call.group_inputs:
                    if f in fresh:      # persistent: window from the carry
                        padded[f], ipad[f] = fresh[f], fpad[f]
                    else:               # transient: exchange to the call
                        padded[f] = _exchange(
                            {idx: env[idx][f] for idx in shards.index},
                            call.halo_lo, call.halo_hi, call.align_hi,
                            shard, bnd[f] == "periodic", f)
                for idx in shards.index:
                    with shards.on(idx):
                        res = call({f: padded[f][idx]
                                    for f in call.group_inputs},
                                   svec[shards.device[idx]],
                                   pcs[idx][first + k],
                                   input_pad=ipad or None,
                                   origin=shards.origin[idx],
                                   device=shards.device[idx])
                    env[idx].update(res)
                    outs[idx].update({f: v for f, v in res.items()
                                      if p.fields[f].role.value == "output"})
            return outs

        def advance(carry, calls_, first):
            fresh = refresh(carry, lead)
            cur = {idx: {f: fresh[f][idx][inner[f]] for f in persistent}
                   for idx in shards.index}
            chained = bool(calls_) and getattr(calls_[0], "returns_fields",
                                               False)
            if backend == "cuda":
                res = kernels(fresh, calls_, first)
            else:
                res = step({idx: {f: fresh[f][idx] for f in persistent}
                            for idx in shards.index}, scalars)
            out = {f: {} for f in persistent}
            for idx in shards.index:
                new = dict(cur[idx])
                if chained:
                    new.update(res[idx])
                else:
                    sd = sdev[shards.device[idx]]
                    with shards.on(idx):
                        if getattr(update, "_takes_origin", False):
                            # shard-aware rules (the serving refresh) mask
                            # in global coordinates
                            new.update(update(cur[idx], res[idx], sd,
                                              origin=shards.origin[idx]))
                        else:
                            new.update(update(cur[idx], res[idx], sd))
                wb = write_back({f: fresh[f][idx] for f in persistent},
                                cur[idx], new, inner, spec.carry_write, bnd,
                                zero_pad)
                for f in persistent:
                    out[f][idx] = wb[f]
            return out

        for _ in range(int(spec.steps) // chain):
            carry = advance(carry, calls, 0)
        if int(spec.steps) % chain:
            carry = advance(carry, epilogue, len(calls))
        return {f: shards.gather({idx: carry[f][idx][inner[f]]
                                  for idx in shards.index}, lead)
                for f in persistent}

    run.calls = list(calls) + list(epilogue)
    return run


# --------------------------------------------------------------------------
# deprecated standalone entry point
# --------------------------------------------------------------------------

def make_sharded_executor(p: Program, global_grid, mesh,
                          mesh_axes: Sequence, *,
                          plan: DataflowPlan | None = None,
                          backend: str = "cuda", dtype: str = "float32"):
    """Deprecated: use ``compile_program(p, grid, mesh=..., mesh_axes=...)``.

    Kept as a thin forwarding wrapper; the returned executable is a
    :class:`~repro_torch.core.pipeline.CompiledStencil` with the legacy
    ``local_grid`` / ``mesh_axes`` / ``field_spec`` attributes attached
    (``field_spec``: the mesh axis of each grid axis)."""
    warnings.warn(
        "make_sharded_executor is deprecated; call "
        "compile_program(p, grid, mesh=..., mesh_axes=...) instead",
        DeprecationWarning, stacklevel=2)
    from .pipeline import CompileOptions, compile_program
    ex = compile_program(p, global_grid, options=CompileOptions(
        backend=backend, plan=plan, dtype=dtype, mesh=mesh,
        mesh_axes=mesh_axes))
    ex.local_grid = ex.shard.local_grid
    ex.mesh_axes = ex.shard.mesh_axes
    ex.field_spec = tuple(ex.shard.mesh_axes)
    return ex
