"""Kernel backend orchestrator: Program + DataflowPlan -> executable (the
port of ``repro.core.lower_pallas``).

Runs the plan's fuse groups in order, each as its generated CUDA kernel
(:mod:`repro_torch.kernels.stencil3d`; the kernel's plain PyTorch version
on CPU tensors).  The stream schedule (``core.lower_stream``) drives its
sweep kernels through the same orchestrators.  Fields crossing a group
boundary are materialised in device memory and re-padded for the
consuming group's windows.  All groups
of one compiled program share one translation unit, built by one ``nvcc``
call on first launch.

Every call opens the ``stencil.*`` spans of :func:`obs.call_tracer`
(``stencil.call`` > ``stencil.prologue``, ``stencil.step`` >
``stencil.pad`` / ``stencil.kernel`` / ``stencil.update`` /
``stencil.write_back``; inside the prologue, a pad or a write-back, a
``stencil.wrap`` around each pad of a field periodic on some axis) and
adds to the ``stencil.*`` counters of :func:`obs.global_metrics`
(:class:`Counts`).  With tracing off the spans
are the no-op singleton's; while torch's profiler runs they are
``record_function`` ranges too, so device operations can be put down to
the step that launched them.

Every executable these orchestrators return also runs a batch of requests
(``run(..., batched=True)``; the serving engine's, through
``pipeline.batched_executable``): fields ``(B, *grid)``, coefficients ``(B,
n)``, scalars ``(B,)`` each.  Pads apply to the grid axes, and each kernel
runs the whole batch in one launch.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..kernels.stencil3d import bind, build_group_call
from ..obs.metrics import global_metrics
from ..obs.trace import call_tracer
from . import boundary as bc
from .ir import Program
from .lower_torch import fresh_carry, write_back
from .schedule import DataflowPlan, TimeLoopSpec, adapt_update

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


class Counts:
    """The orchestrator's counters in :func:`global_metrics`, bound once an
    executable: ``stencil.calls`` and ``stencil.steps`` (steps advanced);
    ``stencil.pad_bytes``, the bytes of every new buffer a pad makes (in
    ``stencil.pad`` and ``stencil.prologue``; a pad that returns its input
    makes none); ``stencil.carry_bytes``, the bytes each write-back writes
    (a rebuilt buffer, or the interior copied in place);
    ``stencil.carry_writes``, fields written back;
    ``stencil.carry_unchanged``, those of them the update left unchanged;
    ``stencil.carry_inplace``, those whose carry buffer the write-back
    kept (copied into, or left as it was); and ``stencil.wrap_bytes``, the
    bytes of the buffers that pads filling wraparound slabs make (in
    ``stencil.wrap``; part of ``pad_bytes`` or ``carry_bytes``)."""

    __slots__ = ("calls", "steps", "pad_bytes", "carry_bytes",
                 "carry_writes", "carry_unchanged", "carry_inplace",
                 "wrap_bytes")

    def __init__(self):
        m = global_metrics()
        for name in self.__slots__:
            setattr(self, name, m.counter("stencil." + name))

    def padded(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``y``, the pad of ``x``, counted in ``stencil.pad_bytes``."""
        if y is not x:
            self.pad_bytes.inc(y.nbytes)
        return y

    def wrapped(self, tracer, boundary, x: torch.Tensor, pad
                ) -> torch.Tensor:
        """``pad(x)``, a pad of a field of ``boundary``: where that wraps
        on some axis, inside a ``stencil.wrap`` span, its new buffer
        counted in ``stencil.wrap_bytes``."""
        if not bc.any_periodic(boundary):
            return pad(x)
        with tracer.span("stencil.wrap"):
            y = pad(x)
        if y is not x:
            self.wrap_bytes.inc(y.nbytes)
        return y


def _pad_coeffs(p: Program, calls, coeffs, dtype, device, counts: Counts):
    """Per-call padded coefficient arrays ('small data', paper step 8),
    ``(n,)`` or, a row a batch element, ``(B, n)``."""
    out = []
    for call in calls:
        pc = {}
        for c in call.group_coeffs:
            ax = call.coeff_axis[c]
            x = torch.as_tensor(coeffs[c], dtype=dtype, device=device)
            pc[c] = counts.padded(x, bc.pad_coeff(
                x, call.pad_lo[ax], call.pad_hi[ax],
                bc.coeff_mode(p, ax)).contiguous())
        out.append(pc)
    return out


def _run_groups(p: Program, calls, svec, pc_per_call, resolve_input,
                device, tracer):
    """Run the fuse groups in order on ``device``, materialising
    inter-group fields, each kernel in a ``stencil.kernel`` span.

    ``resolve_input(call, f, env) -> (tensor, actual_pad | None)`` supplies
    each group input: either freshly padded to the call's window geometry
    (pad None) or an oversized persistent buffer with its actual padding,
    from which the kernel reads its window via ``input_pad``.
    """
    env: dict = {}
    outputs: dict = {}
    for call, pc in zip(calls, pc_per_call):
        padded, ipad = {}, {}
        for f in call.group_inputs:
            padded[f], actual = resolve_input(call, f, env)
            if actual is not None:
                ipad[f] = actual
        with tracer.span("stencil.kernel") as sp:
            if tracer.enabled:
                sp.set(entry=call.entry)
            res = call(padded, svec, pc, input_pad=ipad or None,
                       device=device)
        env.update(res)
        for f, v in res.items():
            if p.fields[f].role.value == "output":
                outputs[f] = v
    return outputs


def _call_attrs(p: Program, calls, steps: int, batched: bool,
                fields: Mapping) -> dict:
    """``stencil.call``'s attributes (built only when a tracer records)."""
    return {"program": p.name, "schedule": calls[0].schedule,
            "steps": int(steps),
            "batch": (next(iter(fields.values())).shape[0] if batched
                      else 1)}


def scalar_vector(p: Program, scalars, device, batched: bool = False,
                  fields: Mapping | None = None) -> torch.Tensor:
    """Runtime scalars as the kernels read them, in program order: a
    float32 ``(n_scalars,)`` tensor on ``device`` for one request, or
    ``(B, n_scalars)`` for a batch whose scalars are ``(B,)`` each.  A
    batched program without scalars gets ``(B, 0)``, ``B`` the leading
    extent of ``fields``, so that a group reading nothing still sees the
    batch."""
    raw = [scalars[s] for s in p.scalars]
    # values on the host cross to the card in one copy
    where = device if any(isinstance(v, torch.Tensor) and v.device.type
                          != "cpu" for v in raw) else "cpu"
    vals = [torch.as_tensor(v, dtype=torch.float32, device=where)
            for v in raw]
    if vals and batched:
        out = torch.stack([v.reshape(-1) for v in vals], dim=1)
    elif vals:
        out = torch.stack([v.reshape(()) for v in vals])
    elif batched:
        out = torch.zeros((next(iter(fields.values())).shape[0], 0),
                          dtype=torch.float32)
    else:
        out = torch.zeros((0,), dtype=torch.float32)
    return out.to(device)


def update_scalars(p: Program, scalars, batched: bool, device) -> dict:
    """The scalars an update rule sees: as given for one request; for a
    batch, a ``(B, 1, ..., 1)`` tensor each, which broadcasts against the
    ``(B, *grid)`` fields."""
    if not batched:
        return scalars
    return {s: torch.as_tensor(v, device=device).reshape(
        (-1,) + (1,) * p.ndim) for s, v in scalars.items()}


def _make_calls(p: Program, plan: DataflowPlan, grid_shape):
    dtype = DTYPES[plan.dtype]
    calls = [build_group_call(p, grp, plan.block, grid_shape, dtype=dtype)
             for grp in plan.groups]
    bind(calls)
    return dtype, calls


def lower(p: Program, plan: DataflowPlan, grid_shape, device):
    """Return fn(fields, scalars, coeffs) -> dict of output tensors."""
    grid_shape = tuple(int(g) for g in grid_shape)
    dtype, calls = _make_calls(p, plan, grid_shape)
    return lower_from_calls(p, dtype, calls, device)


def lower_from_calls(p: Program, dtype, calls, device):
    """Single-step orchestrator over prebuilt kernel calls."""
    counts = Counts()
    bnd = p.boundaries()

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None, *, batched: bool = False):
        tracer = call_tracer()
        with tracer.call("stencil.call") as sp:
            if tracer.enabled:
                sp.set(**_call_attrs(p, calls, 1, batched, fields))
            counts.calls.inc()
            counts.steps.inc()
            with tracer.span("stencil.prologue"):
                ext = {k: torch.as_tensor(v, dtype=dtype, device=device)
                       for k, v in fields.items()}
                svec = scalar_vector(p, scalars or {}, device, batched, ext)
                pc = _pad_coeffs(p, calls, coeffs or {}, dtype, device,
                                 counts)

            def resolve(call, f, env):
                x = env[f] if f in env else ext[f]
                with tracer.span("stencil.pad"):
                    return counts.padded(x, counts.wrapped(
                        tracer, bnd[f], x, lambda x: bc.pad_field(
                            x, call.halo_lo, call.halo_hi, bnd[f],
                            align_hi=call.align_hi).contiguous())), None

            with tracer.span("stencil.step"):
                return _run_groups(p, calls, svec, pc, resolve, device,
                                   tracer)

    run.calls = calls
    return run


def lower_time_loop(p: Program, plan: DataflowPlan, grid_shape,
                    spec: TimeLoopSpec, update, device):
    """Return fn(fields, scalars, coeffs) -> final fields after
    ``spec.steps`` iterations.

    One *pre-padded* persistent buffer per program input field, sized by
    ``spec.field_pad`` so every consuming fuse group reads its window
    straight out of it (the kernel's ``input_pad`` path: a base offset and
    the buffer's strides, no copy).  The reference's ``lax.fori_loop``
    becomes a plain Python loop over these buffers.  Halo slabs follow each
    field's boundary: zero slabs never change, so ``carry_write="inplace"``
    (the default) copies only the changed interiors into the buffer, in
    place (``copy_`` into the interior view); ``"repad"`` rebuilds interior
    plus halo slabs in a new buffer; a field periodic on some axis is
    always rebuilt from the new interior (its wraparound slabs in
    ``stencil.wrap`` spans).  Coefficients are loop-invariant and padded
    once.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    dtype, calls = _make_calls(p, plan, grid_shape)
    return time_loop_from_calls(p, dtype, grid_shape, spec, update, calls,
                                device)


def time_loop_from_calls(p: Program, dtype, grid_shape, spec: TimeLoopSpec,
                         update, calls, device, chain: int = 1,
                         epilogue=None):
    """Fused-loop orchestrator over prebuilt kernel calls (shared with the
    stream schedule, whose carries have no alignment slab).

    ``chain`` is how many time steps one pass over ``calls`` advances: 1
    for plain kernels (stencil outputs, then one update here), T for a
    temporally blocked stream chain, which applies all T updates in-kernel
    and *returns the new fields* (``call.returns_fields``), so the loop
    only writes them back into the carry.  The loop runs
    ``spec.steps // chain`` times; ``epilogue``, a second call list
    advancing ``spec.steps % chain`` steps, runs once after it and reads
    its (shallower) windows out of the same carry through ``input_pad``.
    """
    update = adapt_update(update)
    ndim = p.ndim
    chain = max(1, int(chain))
    if int(spec.steps) % chain and epilogue is None:
        raise ValueError(
            f"steps={spec.steps} is not a multiple of the chain depth "
            f"{chain} and no remainder epilogue was provided")
    fpad = spec.field_pad
    bnd = p.boundaries()
    align = spec.align_hi or (0,) * ndim
    interior = {f: tuple(slice(int(fpad[f][a, 0]),
                               int(fpad[f][a, 0]) + grid_shape[a])
                         for a in range(ndim))
                for f in spec.persistent}

    def refill(f, x):
        # halo slabs per the field's boundary; the tile-alignment slab
        # (inside fpad[:, 1]) is always zero — never read in-domain
        return bc.pad_field(x, fpad[f][:, 0],
                            [int(fpad[f][a, 1]) - int(align[a])
                             for a in range(ndim)],
                            bnd[f], align_hi=align).contiguous()

    counts = Counts()
    steps = int(spec.steps)

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None, *, batched: bool = False):
        tracer = call_tracer()

        def pad_carry(f, x):
            return counts.wrapped(tracer, bnd[f], x, lambda x: refill(f, x))

        with tracer.call("stencil.call") as sp:
            if tracer.enabled:
                sp.set(**_call_attrs(p, calls, steps, batched, fields))
            counts.calls.inc()
            counts.steps.inc(steps)
            with tracer.span("stencil.prologue"):
                scalars = scalars or {}
                coeffs = coeffs or {}
                svec = scalar_vector(p, scalars, device, batched, fields)
                upd_scalars = update_scalars(p, scalars, batched, device)
                pc_per_call = _pad_coeffs(p, calls, coeffs, dtype, device,
                                          counts)
                pc_epilogue = (_pad_coeffs(p, epilogue, coeffs, dtype,
                                           device, counts)
                               if epilogue else None)
                carry = {}
                for f in spec.persistent:
                    x = torch.as_tensor(fields[f], dtype=dtype,
                                        device=device)
                    carry[f] = counts.padded(x, fresh_carry(pad_carry, f,
                                                            x))
            # a batch's carries keep their leading axis whole
            inner = {f: (slice(None),) * batched + interior[f]
                     for f in spec.persistent}

            def resolve(call, f, env):
                if f in carry:          # persistent: window from carry
                    return carry[f], fpad[f]
                with tracer.span("stencil.pad"):
                    return counts.padded(env[f], counts.wrapped(
                        tracer, bnd[f], env[f], lambda x: bc.pad_field(
                            x, call.halo_lo, call.halo_hi, bnd[f],
                            align_hi=call.align_hi).contiguous())), None

            def advance(calls_, pc_):
                with tracer.span("stencil.step"):
                    cur = {f: carry[f][inner[f]] for f in spec.persistent}
                    new = dict(cur)
                    if getattr(calls_[0], "returns_fields", False):
                        # a chained sweep: one call advances every field by
                        # its chain depth, updates included
                        call = calls_[0]
                        with tracer.span("stencil.kernel") as sk:
                            if tracer.enabled:
                                sk.set(entry=call.entry)
                            new.update(call(
                                {f: carry[f] for f in call.group_inputs},
                                svec, pc_[0],
                                input_pad={f: fpad[f]
                                           for f in call.group_inputs},
                                device=device))
                    else:
                        outputs = _run_groups(p, calls_, svec, pc_, resolve,
                                              device, tracer)
                        with tracer.span("stencil.update"):
                            new.update(update(cur, outputs, upd_scalars))
                    with tracer.span("stencil.write_back"):
                        return write_back(carry, cur, new, inner,
                                          spec.carry_write, bnd, pad_carry,
                                          counts)

            for _ in range(steps // chain):
                carry = advance(calls, pc_per_call)
            if steps % chain:
                carry = advance(epilogue, pc_epilogue)
            return {f: carry[f][inner[f]] for f in spec.persistent}

    run.calls = list(calls) + list(epilogue or [])
    return run
