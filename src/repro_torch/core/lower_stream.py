"""Stream backend: StreamGraph regions -> shift-register sweep kernels (the
port of ``repro.core.lower_stream``).

Per legalised region one CUDA sweep kernel
(:class:`repro_torch.kernels.stream3d.StreamCall`), generated from the IR;
every region of a compiled program (and a chain's remainder epilogue) goes
into one translation unit, built by one ``nvcc`` call.  The calls carry
the same geometry attributes as the block kernels, so the orchestrators of
:mod:`repro_torch.core.lower_kernel` drive both alike.

With ``time_tile = T > 1`` the fused loop's update rule runs inside the
kernel between chain stages.  The reference traces the Python rule with
JAX; here :func:`trace_update` calls it on proxies whose arithmetic builds
IR expressions (``frontend.ExprHandle``), which the emitter then compiles
like any op.  A rule that does not trace is reported by :func:`trace_update`
and the compile demotes the chain to ``time_tile=1`` (the rule then runs
on the host once per step).
"""

from __future__ import annotations

from typing import Sequence

from ..kernels.stencil3d import bind
from ..kernels.stream3d import StreamCall
from .dataflow import StreamGraph, lower_to_dataflow
from .frontend import ExprHandle, _wrap
from .ir import Access, Program, ScalarRef
from .lower_kernel import DTYPES, lower_from_calls, time_loop_from_calls
from .schedule import DataflowPlan, TimeLoopSpec, adapt_update


def trace_update(p: Program, update, fields: Sequence[str],
                 outputs: Sequence[str]):
    """Trace a fused-loop update rule into one IR expression per field.

    ``update(fields, outputs[, scalars])`` is called once on proxies: each
    field is ``Access(field, 0)``, each output ``Access(output, 0)``, each
    scalar a ``ScalarRef``.  Returns ``(exprs, None)``, ``exprs`` mapping
    every field of ``fields`` to its new value (unchanged fields map to
    their own access), or ``(None, reason)`` when the rule does not trace:
    it calls a function that takes tensors only, branches on a value, or
    returns something that is not an expression or a number."""
    zero = (0,) * p.ndim
    cur = {f: ExprHandle(Access(f, zero)) for f in fields}
    outs = {o: ExprHandle(Access(o, zero)) for o in outputs}
    scal = {s: ExprHandle(ScalarRef(s)) for s in p.scalars}
    try:
        res = adapt_update(update)(dict(cur), outs, scal)
        merged = dict(cur)
        merged.update(res)
        return {f: _wrap(merged[f]) for f in fields}, None
    except Exception as e:              # any failure means: not traceable
        return None, (f"update rule does not trace into the kernel "
                      f"({type(e).__name__}: {e})")


def _calls(p: Program, plan: DataflowPlan, grid_shape, graph: StreamGraph):
    dtype = DTYPES[plan.dtype]
    return dtype, [StreamCall(p, region, grid_shape, dtype=dtype,
                              plane_tile=graph.plane_tile)
                   for region in graph.regions]


def lower(p: Program, plan: DataflowPlan, grid_shape, device,
          graph: StreamGraph | None = None):
    """Return fn(fields, scalars, coeffs) -> outputs, one streamed sweep
    per region.  Single steps never chain (there is no update rule to
    apply between stages), so ``time_tile`` is ignored here; the graph's
    effective ``plane_tile`` applies."""
    grid_shape = tuple(int(g) for g in grid_shape)
    if graph is None:
        graph = lower_to_dataflow(p, plan, grid_shape)
    dtype, calls = _calls(p, plan, grid_shape, graph)
    bind(calls)
    return lower_from_calls(p, dtype, calls, device)


def lower_time_loop(p: Program, plan: DataflowPlan, grid_shape,
                    spec: TimeLoopSpec, update, device,
                    graph: StreamGraph | None = None):
    """Fused time loop over streamed sweeps: the carry holds pre-padded
    persistent fields (no alignment slab), and each step runs every
    region's sweep.

    With an effective ``time_tile = T > 1`` each loop iteration runs ONE
    chained sweep that advances T steps (all T updates in-kernel; the call
    returns the new fields), so the loop runs ``spec.steps // T`` times; a
    ``spec.steps % T`` remainder runs once after it, through a second,
    shallower chain built from the same region."""
    grid_shape = tuple(int(g) for g in grid_shape)
    if graph is None:
        graph = lower_to_dataflow(p, plan, grid_shape)
    T, P = int(graph.time_tile), int(graph.plane_tile)
    if T <= 1:
        dtype, calls = _calls(p, plan, grid_shape, graph)
        bind(calls)
        return time_loop_from_calls(p, dtype, grid_shape, spec, update,
                                    calls, device)
    dtype = DTYPES[plan.dtype]
    region = graph.regions[0]       # chain legality implies a single region
    upd = adapt_update(update)
    outs = [p.ops[i].out for i in region.ops
            if p.ops[i].out in set(region.halo.group_outputs)]
    exprs, reason = trace_update(p, upd, region.halo.group_inputs, outs)
    if exprs is None:
        raise ValueError(f"time_tile={T} needs an update rule that traces "
                         f"into the kernel: {reason}")

    def chain(depth):
        return StreamCall(p, region, grid_shape, dtype=dtype,
                          time_tile=depth, update=upd, update_exprs=exprs,
                          plane_tile=P)

    calls = [chain(T)]
    rem = int(spec.steps) % T
    epilogue = [chain(rem)] if rem else None
    bind(calls + (epilogue or []))
    return time_loop_from_calls(p, dtype, grid_shape, spec, update, calls,
                                device, chain=T, epilogue=epilogue)
