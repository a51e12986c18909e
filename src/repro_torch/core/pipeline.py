"""End-to-end entry point: Program -> DataflowPlan -> executable, on the card
(the port of ``repro.core.pipeline``).

    prog = pw_advection()
    ex = compile_program(prog, (512, 256, 256))          # runs on "cuda"
    out = ex(fields, scalars, coeffs)                    # dict of tensors

Backends:
    "cuda"         generated CUDA C++ kernels (the default): fuse-group
                   kernels under ``schedule="block"``, shift-register sweep
                   kernels under ``schedule="stream"`` (with ``time_tile``
                   and ``plane_tile``)
    "torch_fused"  full-tensor evaluation with one shared memo
    "torch_naive"  op-at-a-time full-tensor evaluation

Entry points run on the card unless ``device="cpu"`` is passed (the tests
do: the ``"cuda"`` backend then runs each kernel's plain PyTorch version
through the same orchestrator).  With no card and no ``device="cpu"`` the
compile raises; it never falls back to the CPU.

``mesh=`` (a :class:`~repro_torch.dist.sharding.Mesh`) with ``mesh_axes=``
runs the program SPMD over the mesh's devices
(:mod:`repro_torch.core.distribute`): the planner prices the shard-local
grid, and the executable takes and returns global tensors.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping

import torch

from ..kernels import build
from ..obs.events import ChainDemoted, PlanChosen
from ..obs.metrics import global_metrics
from ..obs.trace import resolve_tracer
from . import dataflow, distribute, lower_kernel, lower_stream, lower_torch
from .ir import Program
from .passes import infer_halo
from .schedule import (DataflowPlan, ShardSpec, TimeLoopSpec, auto_plan,
                       make_shard_spec, normalize_mesh_axes, plan_time_loop,
                       shard_local_grid)

_BACKENDS = ("cuda", "torch_fused", "torch_naive")


class TileDemotionWarning(UserWarning):
    """An explicitly requested ``time_tile``/``plane_tile`` was demoted by
    stream legalisation, or by an update rule the chain cannot run
    in-kernel."""


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Every compile-time knob of :func:`compile_program`, as one frozen
    value object.  Loose keyword arguments with the same names are
    accepted and normalised into one; passing a knob both ways with
    different values raises.

    ``device`` is where the executable runs: ``None`` means the card
    (``"cuda"``), and raises when there is none; ``"cpu"`` runs the same
    orchestration on the CPU (the ``"cuda"`` backend then uses each
    kernel's plain PyTorch version).

    ``strategy="tuned"`` replaces the ``auto_plan`` heuristic with the
    measured search of :mod:`repro_torch.core.tune` on ``device``:
    ``plan_cache`` (:class:`~repro_torch.core.tune.PlanCache`) is consulted
    first, and a miss measures the model-pruned candidates and stores the
    winner; ``tune_config`` (:class:`~repro_torch.core.tune.TuneConfig`)
    sets the search's knobs.  ``carry_write=None`` defers to the tuned
    style (``"repad"`` under any other strategy).

    ``mesh=`` (:func:`repro_torch.dist.make_auto_mesh`) runs the compile
    over a mesh of devices with ``mesh_axes`` (one mesh axis name or None
    per grid axis; ``mesh.axis_names`` by default): the mesh's devices
    decide where the executable runs, and a ``device`` that disagrees with
    them raises.
    """

    backend: str = "cuda"
    plan: DataflowPlan | None = None
    dtype: str = "float32"
    strategy: str = "auto"
    steps: int | None = None
    update: object = None
    carry_write: str | None = None
    tune_config: object = None
    plan_cache: object = None
    mesh: object = None
    mesh_axes: tuple | None = None
    boundary: object = None
    schedule: str | None = None
    time_tile: int | None = None
    plane_tile: int | None = None
    trace: object = None
    device: object = None


_OPTION_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(CompileOptions)}


def _resolve_options(options, kwargs) -> CompileOptions:
    """Merge the ``options=`` object and loose kwargs into one validated
    :class:`CompileOptions` (the single normalisation point)."""
    unknown = set(kwargs) - set(_OPTION_DEFAULTS)
    if unknown:
        raise TypeError(
            "unknown compile option(s) "
            + ", ".join(sorted(repr(k) for k in unknown))
            + "; valid options: "
            + ", ".join(sorted(_OPTION_DEFAULTS)))
    if options is None:
        return CompileOptions(**kwargs)
    if not isinstance(options, CompileOptions):
        raise TypeError(
            f"options= must be a CompileOptions, got "
            f"{type(options).__name__}")
    if not kwargs:
        return options
    for k, v in kwargs.items():
        cur = getattr(options, k)
        if cur is v or cur == _OPTION_DEFAULTS[k]:
            continue            # kwarg refines a knob the options left alone
        try:
            same = bool(v == cur)
        except Exception:
            same = False
        if not same:
            raise ValueError(
                f"compile option {k!r} passed both in options= ({cur!r}) "
                f"and as a keyword ({v!r}); set it one way, not both")
    return dataclasses.replace(options, **kwargs)


def resolve_device(device) -> torch.device:
    """``None`` -> the card; raises when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card — pass "
            "device='cpu' to run its plain PyTorch versions on the CPU")
    return dev


def _check_schedule(backend: str, schedule: str | None) -> None:
    """THE capability gate for schedule x backend combinations: the block
    schedule runs on every backend, the stream schedule on ``"cuda"``."""
    if schedule not in (None, "block", "stream"):
        raise ValueError(f"unknown schedule {schedule!r}; valid: 'block', "
                         "'stream'")
    if schedule == "stream" and backend != "cuda":
        raise ValueError(
            "schedule='stream' is a CUDA dataflow schedule; backend "
            f"{backend!r} has no streaming lowering. Valid combinations: "
            "schedule='block' with any backend, or schedule='stream' with "
            "backend='cuda' (time_tile >= 1, plane_tile >= 1)")


@dataclasses.dataclass
class CompiledStencil:
    program: Program
    plan: DataflowPlan
    grid: tuple
    _fn: object
    device: torch.device
    # fused time loop (``steps=N``): the executable returns the *final
    # fields* after N iterations instead of one step's outputs
    time_spec: TimeLoopSpec | None = None
    # the group kernels the executable launches, in order (backend "cuda")
    kernels: list = dataclasses.field(default_factory=list)
    # distributed layout (``mesh=``); None for a local compile
    shard: ShardSpec | None = None

    def __call__(self, fields: Mapping, scalars: Mapping | None = None,
                 coeffs: Mapping | None = None) -> dict:
        return self._fn(dict(fields), dict(scalars or {}), dict(coeffs or {}))


def compile_program(p: Program, grid, *,
                    options: CompileOptions | None = None,
                    **kwargs) -> CompiledStencil:
    """Compile ``p`` for ``grid`` — single-step or fused loop — to run on
    ``device`` (the card by default).

    With ``steps=N`` and an ``update(fields, outputs) -> fields`` rule, the
    executable maps initial fields to the fields after N steps: the input
    fields stay resident and pre-padded on the device across the loop, and
    each step's kernels read their windows straight out of those buffers.

    ``boundary=`` overrides the program's per-field boundary declarations
    (``"zero"`` / ``"periodic"`` or a ``{field: kind}`` mapping).

    ``schedule="stream"`` sweeps each legalised region along axis 0 with a
    shift-register kernel.  ``time_tile=T`` (needs ``steps``/``update``)
    chains T steps through every sweep: the loop runs ``steps // T``
    chained sweeps plus one remainder sweep.  ``plane_tile=P`` advances P
    planes per step of the sweep.  Legalisation may demote either to an
    *effective* 1 (``plan.stream.time_tile``/``plane_tile``); an explicit
    request that was demoted warns ``TileDemotionWarning``.
    """
    o = _resolve_options(options, kwargs)
    tracer = resolve_tracer(o.trace)
    with tracer.active(), tracer.span(
            "compile", program=p.name,
            grid="x".join(str(int(g)) for g in grid),
            backend=o.backend, strategy=o.strategy) as sp:
        return _compile(p, grid, o, tracer, sp)


def _compile(p: Program, grid, o: CompileOptions, tracer,
             sp) -> CompiledStencil:
    backend, plan, dtype = o.backend, o.plan, o.dtype
    steps, update, carry_write = o.steps, o.update, o.carry_write
    metrics = global_metrics()
    metrics.counter("compile.compiles").inc()

    grid = tuple(int(g) for g in grid)
    if len(grid) != p.ndim:
        raise ValueError(f"grid rank {len(grid)} != program ndim {p.ndim}")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: "
                         + ", ".join(repr(b) for b in _BACKENDS))
    _check_schedule(backend, o.schedule)
    time_tile, plane_tile = o.time_tile, o.plane_tile
    for knob, v in (("time_tile", time_tile), ("plane_tile", plane_tile)):
        if v is not None and int(v) < 1:
            raise ValueError(f"{knob} must be >= 1, got {v}")
    if time_tile is not None and int(time_tile) > 1 and steps is None:
        raise ValueError(
            "time_tile > 1 pipelines T time steps through one stream "
            "sweep, which applies the update rule in-kernel — it needs "
            "the fused loop: pass steps=N and update=")
    mesh, mesh_axes = o.mesh, o.mesh_axes
    if mesh is not None:
        if mesh_axes is None:
            mesh_axes = tuple(mesh.axis_names)
        mesh_axes = normalize_mesh_axes(mesh_axes, p.ndim)
        # the planner prices CTAs against the per-shard local grid
        plan_grid = shard_local_grid(grid, mesh, mesh_axes)
        device = mesh_device(mesh, o.device)
    elif mesh_axes is not None:
        raise ValueError("mesh_axes requires mesh=")
    else:
        plan_grid = grid
        device = resolve_device(o.device)
    if o.boundary is not None:
        p = p.with_boundary(o.boundary)

    tuned = None
    if plan is None and o.strategy == "tuned":
        from . import tune
        tuned = tune.get_tuned_plan(p, grid, backend=backend, dtype=dtype,
                                    update=update, config=o.tune_config,
                                    cache=o.plan_cache, device=device,
                                    mesh=mesh, mesh_axes=mesh_axes)
        plan, carry_write = tuned.plan, carry_write or tuned.carry_write
    elif plan is None:
        plan = auto_plan(p, plan_grid, backend=backend, dtype=dtype,
                         strategy=o.strategy, steps=steps,
                         schedule=o.schedule or "block",
                         time_tile=int(time_tile or 1),
                         plane_tile=int(plane_tile or 1))
    # the executable always gets its own copy, retargeted to the backend
    # and to any explicitly requested schedule or tile
    overrides = {"backend": backend}
    if mesh is not None and plan.mesh_axes_for(p.ndim) != mesh_axes:
        overrides["mesh_axes"] = mesh_axes
    if time_tile is not None:
        overrides["time_tile"] = int(time_tile)
    if plane_tile is not None:
        overrides["plane_tile"] = int(plane_tile)
    if o.schedule is not None and plan.schedule != o.schedule:
        # a stream plan's block is a one-plane placeholder: retargeting it
        # to the block schedule re-derives a real tile
        overrides.update(schedule=o.schedule, stream=None)
        if o.schedule == "block":
            overrides.setdefault("time_tile", 1)
            overrides.setdefault("plane_tile", 1)
            overrides["block"] = auto_plan(p, plan_grid, backend=backend,
                                           dtype=plan.dtype).block
    plan = dataclasses.replace(plan, groups=[list(g) for g in plan.groups],
                               **overrides)
    _check_schedule(backend, plan.schedule)
    carry_write = carry_write or "repad"

    graph = None
    group_halos = None
    stream_axis = None
    if plan.schedule == "stream":
        metrics.counter("compile.stream_lowerings").inc()
        stream_axis = dataflow.STREAM_AXIS
        # a mesh that cuts the sweep axis needs exact, chain-deepened ghost
        # planes on the lo side; the dataflow graph carries them
        stream_sharded = (mesh is not None
                          and mesh_axes[stream_axis] is not None
                          and int(mesh.shape[mesh_axes[stream_axis]]) > 1)
        graph, plan = _legalise_stream(p, plan, plan_grid, steps, update,
                                       time_tile, plane_tile, tracer,
                                       stream_sharded)
        group_halos = graph.group_halos()

    shard = None
    if mesh is not None:
        # one halo inference a kernel, shared by the shard spec and the
        # carry sizing (stream plans made theirs above, ghost-exact and
        # chain-deepened)
        if group_halos is None:
            group_halos = [infer_halo(p, grp) for grp in plan.groups]
        shard = make_shard_spec(p, plan, grid, mesh, mesh_axes,
                                group_halos=group_halos,
                                stream_axis=stream_axis)

    time_spec = None
    if steps is not None:
        if update is None:
            raise ValueError("steps=N requires an update(fields, outputs) "
                             "rule to close the time loop")
        time_spec = plan_time_loop(p, plan, plan_grid, steps,
                                   carry_write=carry_write,
                                   group_halos=group_halos, shard=shard)
        if mesh is not None:
            fn = distribute.lower_sharded_time_loop(p, plan, grid, time_spec,
                                                    update, mesh, graph=graph)
        elif graph is not None:
            fn = lower_stream.lower_time_loop(p, plan, grid, time_spec,
                                              update, device, graph=graph)
        elif backend == "cuda":
            fn = lower_kernel.lower_time_loop(p, plan, grid, time_spec,
                                              update, device)
        else:
            fn = _on_device(lower_torch.lower_time_loop(
                p, backend.removeprefix("torch_"), time_spec, update),
                p, plan.dtype, device)
        metrics.counter("compile.fused_loops").inc()
    elif mesh is not None:
        fn = distribute.lower_sharded(p, plan, grid, shard, mesh,
                                      graph=graph)
    elif graph is not None:
        fn = lower_stream.lower(p, plan, grid, device, graph=graph)
    elif backend == "cuda":
        fn = lower_kernel.lower(p, plan, grid, device)
    else:
        fn = _on_device(lower_torch.lower(p, backend.removeprefix("torch_")),
                        p, plan.dtype, device)
    if tracer.enabled:
        eff = plan.stream if plan.stream is not None else plan
        sp.set(schedule=plan.schedule, time_tile=int(eff.time_tile),
               plane_tile=int(eff.plane_tile), steps=steps,
               device=str(device),
               mesh=None if mesh is None else dict(mesh.shape))
        if o.plan is None:
            rec = tuned.record if tuned is not None else {}
            tracer.emit(PlanChosen(
                program=p.name, backend=backend, schedule=plan.schedule,
                strategy=o.strategy, label=rec.get("label", "auto_plan"),
                time_tile=int(eff.time_tile),
                plane_tile=int(eff.plane_tile),
                modeled_us=rec.get("modeled_us"),
                measured_us=rec.get("us_fused") or rec.get("us_single"),
                roofline_fraction=rec.get("roofline_fraction")))
    ex = CompiledStencil(program=p, plan=plan, grid=grid, _fn=fn,
                         device=device, time_spec=time_spec,
                         kernels=list(getattr(fn, "calls", [])),
                         shard=shard)
    if backend == "cuda" and device.type == "cuda":
        # nvcc starts now, in the background: programs compiled one after
        # another build at once, and a build overlaps the caller's work
        # before the first launch
        build.start(k.module.source for k in ex.kernels
                    if getattr(k, "module", None) is not None)
    return ex


def mesh_device(mesh, device) -> torch.device:
    """Where a compile over ``mesh`` runs: the mesh's first device, where
    its outputs gather (every device of the mesh checked usable).  A
    ``device`` other than that one raises: with ``mesh=`` the mesh decides
    where the executable runs."""
    devs = [torch.device(d) for d in dict.fromkeys(mesh.devices.flat)]
    if device is not None:
        want = torch.device(device)
        if want.type != devs[0].type or (want.index is not None
                                         and want.index != devs[0].index):
            raise ValueError(
                f"device={str(device)!r} disagrees with the mesh's devices "
                f"{[str(x) for x in devs]}; with mesh= the mesh decides "
                "where the executable runs")
    for d in devs:
        resolve_device(d)
    return devs[0]


def _legalise_stream(p: Program, plan: DataflowPlan, grid: tuple, steps,
                     update, time_tile, plane_tile, tracer,
                     stream_sharded: bool = False):
    """Legalise a stream plan once: regions, window depths and rings, and
    the effective tiles, which the carry sizing, the plan's ``stream``
    record and the kernels all share.  A chain whose update rule cannot
    run in-kernel (not plane-local, or not traceable) demotes to
    ``time_tile=1`` with the same event as a legality demotion; an
    explicitly requested tile that was demoted warns.  ``grid`` is the
    shard-local grid under a mesh; ``stream_sharded`` deepens the lo-side
    ghost planes for a mesh that cuts the sweep axis."""
    update_demote = None
    if plan.time_tile > 1 and steps is not None:
        if not getattr(update, "_plane_local", True):
            update_demote = ("update rule is not plane-local (it reads "
                             "beyond the resident planes), so chained "
                             "stages cannot apply it in-kernel")
        else:
            probe = dataflow.lower_to_dataflow(p, plan, grid)
            if probe.time_tile > 1:
                r = probe.regions[0]
                outs = [p.ops[i].out for i in r.ops
                        if p.ops[i].out in set(r.halo.group_outputs)]
                _, update_demote = lower_stream.trace_update(
                    p, update, r.halo.group_inputs, outs)
        if update_demote is not None:
            if tracer.enabled:
                tracer.emit(ChainDemoted(program=p.name,
                                         requested=int(plan.time_tile),
                                         effective=1, reason=update_demote))
            plan = dataclasses.replace(plan, time_tile=1)
    graph = dataflow.lower_to_dataflow(p, plan, grid,
                                       stream_sharded=stream_sharded)
    plan = dataclasses.replace(plan, stream=graph.spec())
    if (time_tile is not None and int(time_tile) > 1
            and graph.time_tile < int(time_tile)):
        reason = update_demote or dataflow.chain_split_reason(
            p, [list(r.ops) for r in graph.regions])
        warnings.warn(f"time_tile={time_tile} demoted to effective "
                      f"{graph.time_tile} for {p.name!r}: {reason}",
                      TileDemotionWarning, stacklevel=4)
    if (plane_tile is not None and int(plane_tile) > 1
            and graph.plane_tile < int(plane_tile)):
        reason = dataflow.plane_split_reason(p, int(plane_tile), grid)
        warnings.warn(f"plane_tile={plane_tile} demoted to effective "
                      f"{graph.plane_tile} for {p.name!r}: {reason}",
                      TileDemotionWarning, stacklevel=4)
    return graph, plan


def _on_device(fn, p: Program, dtype: str, device):
    """Wrap a torch lowering so its inputs arrive as tensors of the plan's
    dtype on ``device`` (numpy arrays and host tensors are accepted)."""
    tdt = lower_kernel.DTYPES[dtype]

    def run(fields, scalars, coeffs):
        fields = {k: torch.as_tensor(v, dtype=tdt, device=device)
                  for k, v in fields.items()}
        coeffs = {k: torch.as_tensor(v, dtype=tdt, device=device)
                  for k, v in coeffs.items()}
        return fn(fields, scalars, coeffs)

    return run


def batched_executable(ex: CompiledStencil):
    """The batched form of ``ex``, the port's counterpart of the reference
    engine's ``jax.jit(jax.vmap(ex._fn))``: ``fn(fields, scalars, coeffs)
    -> dict`` over a batch of B requests on ``ex``'s grid, every field
    ``(B, *grid)``, every scalar ``(B,)``, every coefficient ``(B, n)``;
    the results are ``(B, *grid)``.

    Backend ``"cuda"`` runs the batch natively: each generated kernel has
    a batch axis on its launch grid, so a step costs one launch per kernel
    whatever B is, and the update rule sees each scalar as ``(B, 1, ...,
    1)``.  ``"torch_fused"`` and ``"torch_naive"`` run it unrolled, one
    element after another, as the reference engine's ``fallback_unrolled``
    does for a lowering without a batching rule.  Nothing falls back: an
    error fails the call.
    """
    if ex.plan.backend == "cuda":
        def run(fields, scalars, coeffs):
            return ex._fn(dict(fields), dict(scalars), dict(coeffs),
                          batched=True)
    else:
        def run(fields, scalars, coeffs):
            n = next(iter(fields.values())).shape[0]
            outs = [ex._fn({f: v[i] for f, v in fields.items()},
                           {s: v[i] for s, v in scalars.items()},
                           {c: v[i] for c, v in coeffs.items()})
                    for i in range(n)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return run


def run_time_loop(ex: CompiledStencil, fields: dict, scalars: dict,
                  coeffs: dict, steps: int, update) -> dict:
    """Simple host-side time loop; ``update(fields, outputs) -> fields``."""
    for _ in range(steps):
        out = ex(fields, scalars, coeffs)
        fields = update(fields, out)
    return fields
