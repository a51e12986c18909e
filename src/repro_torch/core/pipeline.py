"""End-to-end entry point: Program -> DataflowPlan -> executable, on the card
(the port of ``repro.core.pipeline``).

    prog = pw_advection()
    ex = compile_program(prog, (512, 256, 256))          # runs on "cuda"
    out = ex(fields, scalars, coeffs)                    # dict of tensors

Backends:
    "cuda"         generated CUDA C++ fuse-group kernels (the default)
    "torch_fused"  full-tensor evaluation with one shared memo
    "torch_naive"  op-at-a-time full-tensor evaluation

Entry points run on the card unless ``device="cpu"`` is passed (the tests
do: the ``"cuda"`` backend then runs each kernel's plain PyTorch version
through the same orchestrator).  With no card and no ``device="cpu"`` the
compile raises; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from ..obs.events import PlanChosen
from ..obs.metrics import global_metrics
from ..obs.trace import resolve_tracer
from . import lower_kernel, lower_torch
from .ir import Program
from .schedule import (STREAM_ITEM, DataflowPlan, TimeLoopSpec, auto_plan,
                       plan_time_loop)

_BACKENDS = ("cuda", "torch_fused", "torch_naive")

#: ROADMAP items that port what this compile path still refuses
_LATER = {
    "schedule": STREAM_ITEM,
    "time_tile": STREAM_ITEM,
    "plane_tile": STREAM_ITEM,
    "mesh": "ROADMAP A7 (distribution)",
    "tuned": "ROADMAP A6 (roofline and tuner)",
}


class TileDemotionWarning(UserWarning):
    """An explicitly requested ``time_tile``/``plane_tile`` was demoted by
    stream legalisation (kept for the reference's API; the port's stream
    schedule is a later slice, so nothing emits it yet)."""


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

    ``schedule="stream"``, ``time_tile > 1``, ``plane_tile > 1``, ``mesh=``
    and ``strategy="tuned"`` raise ``NotImplementedError`` naming the
    ROADMAP item that ports them.
    """

    backend: str = "cuda"
    plan: DataflowPlan | None = None
    dtype: str = "float32"
    strategy: str = "auto"
    steps: int | None = None
    update: object = None
    carry_write: str | None = None
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
    schedule runs on every backend; the stream schedule is not ported."""
    if schedule not in (None, "block", "stream"):
        raise ValueError(f"unknown schedule {schedule!r}; valid: 'block', "
                         "'stream'")
    if schedule == "stream":
        raise NotImplementedError(
            f"schedule='stream' (backend {backend!r}) is not ported yet: "
            f"{STREAM_ITEM}")


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
    for knob in ("time_tile", "plane_tile"):
        v = getattr(o, knob)
        if v is not None and int(v) < 1:
            raise ValueError(f"{knob} must be >= 1, got {v}")
        if v is not None and int(v) > 1:
            raise NotImplementedError(
                f"{knob}={v} is not ported yet: {_LATER[knob]}")
    if o.mesh is not None or o.mesh_axes is not None:
        raise NotImplementedError(f"mesh= is not ported yet: {_LATER['mesh']}")
    if o.strategy == "tuned":
        raise NotImplementedError(
            f"strategy='tuned' is not ported yet: {_LATER['tuned']}")
    device = resolve_device(o.device)
    if o.boundary is not None:
        p = p.with_boundary(o.boundary)

    if plan is None:
        plan = auto_plan(p, grid, backend=backend, dtype=dtype,
                         strategy=o.strategy, steps=steps)
    _check_schedule(backend, plan.schedule)
    # the executable always gets its own copy, retargeted to the backend
    plan = dataclasses.replace(plan, groups=[list(g) for g in plan.groups],
                               backend=backend)
    carry_write = carry_write or "repad"

    time_spec = None
    if steps is not None:
        if update is None:
            raise ValueError("steps=N requires an update(fields, outputs) "
                             "rule to close the time loop")
        time_spec = plan_time_loop(p, plan, grid, steps,
                                   carry_write=carry_write)
        if backend == "cuda":
            fn = lower_kernel.lower_time_loop(p, plan, grid, time_spec,
                                              update, device)
        else:
            fn = _on_device(lower_torch.lower_time_loop(
                p, backend.removeprefix("torch_"), time_spec, update),
                p, plan.dtype, device)
        metrics.counter("compile.fused_loops").inc()
    elif backend == "cuda":
        fn = lower_kernel.lower(p, plan, grid, device)
    else:
        fn = _on_device(lower_torch.lower(p, backend.removeprefix("torch_")),
                        p, plan.dtype, device)
    if tracer.enabled:
        sp.set(schedule=plan.schedule, steps=steps, device=str(device))
        if o.plan is None:
            tracer.emit(PlanChosen(
                program=p.name, backend=backend, schedule=plan.schedule,
                strategy=o.strategy, label="auto_plan"))
    return CompiledStencil(program=p, plan=plan, grid=grid, _fn=fn,
                           device=device, time_spec=time_spec,
                           kernels=list(getattr(fn, "calls", [])))


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


def run_time_loop(ex: CompiledStencil, fields: dict, scalars: dict,
                  coeffs: dict, steps: int, update) -> dict:
    """Simple host-side time loop; ``update(fields, outputs) -> fields``."""
    for _ in range(steps):
        out = ex(fields, scalars, coeffs)
        fields = update(fields, out)
    return fields
