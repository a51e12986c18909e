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
from . import boundary as bc
from .ir import Program
from .lower_torch import fresh_carry, write_back
from .schedule import DataflowPlan, TimeLoopSpec, adapt_update

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def _pad_coeffs(p: Program, calls, coeffs, dtype, device):
    """Per-call padded coefficient arrays ('small data', paper step 8),
    ``(n,)`` or, a row a batch element, ``(B, n)``."""
    cmode = bc.coeff_mode(p)
    out = []
    for call in calls:
        pc = {}
        for c in call.group_coeffs:
            ax = call.coeff_axis[c]
            pc[c] = bc.pad_coeff(
                torch.as_tensor(coeffs[c], dtype=dtype, device=device),
                call.pad_lo[ax], call.pad_hi[ax], cmode).contiguous()
        out.append(pc)
    return out


def _run_groups(p: Program, calls, svec, pc_per_call, resolve_input,
                device, origin=None):
    """Run the fuse groups in order on ``device``, materialising
    inter-group fields.

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
        res = call(padded, svec, pc, input_pad=ipad or None, origin=origin,
                   device=device)
        env.update(res)
        for f, v in res.items():
            if p.fields[f].role.value == "output":
                outputs[f] = v
    return outputs


def scalar_vector(p: Program, scalars, device, batched: bool = False
                  ) -> torch.Tensor:
    """Runtime scalars as the kernels read them, in program order: a
    float32 ``(n_scalars,)`` tensor on ``device``, or ``(B, n_scalars)``
    for a batch whose scalars are ``(B,)`` each."""
    raw = [scalars[s] for s in p.scalars]
    # values on the host cross to the card in one copy
    where = device if any(isinstance(v, torch.Tensor) and v.device.type
                          != "cpu" for v in raw) else "cpu"
    vals = [torch.as_tensor(v, dtype=torch.float32, device=where)
            for v in raw]
    if not vals:
        out = torch.zeros((0,), dtype=torch.float32)
    elif batched:
        out = torch.stack([v.reshape(-1) for v in vals], dim=1)
    else:
        out = torch.stack([v.reshape(()) for v in vals])
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

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None, *, batched: bool = False):
        scalars = scalars or {}
        coeffs = coeffs or {}
        ext = {k: torch.as_tensor(v, dtype=dtype, device=device)
               for k, v in fields.items()}
        bnd = p.boundaries()

        def resolve(call, f, env):
            x = env[f] if f in env else ext[f]
            return bc.pad_field(x, call.halo_lo, call.halo_hi, bnd[f],
                                align_hi=call.align_hi).contiguous(), None

        return _run_groups(p, calls,
                           scalar_vector(p, scalars, device, batched),
                           _pad_coeffs(p, calls, coeffs, dtype, device),
                           resolve, device)

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
    copies only the new interior into the buffer, in place (``copy_`` into
    the interior view); ``"repad"`` (the default) rebuilds interior plus
    halo slabs in a new buffer; periodic slabs are always rebuilt from the
    new interior.  Coefficients are loop-invariant and padded once.
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

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None, *, batched: bool = False):
        scalars = scalars or {}
        coeffs = coeffs or {}
        svec = scalar_vector(p, scalars, device, batched)
        upd_scalars = update_scalars(p, scalars, batched, device)
        pc_per_call = _pad_coeffs(p, calls, coeffs, dtype, device)
        pc_epilogue = (_pad_coeffs(p, epilogue, coeffs, dtype, device)
                       if epilogue else None)
        carry = {f: fresh_carry(refill, f, torch.as_tensor(
            fields[f], dtype=dtype, device=device)) for f in spec.persistent}
        # a batch's carries keep their leading axis whole
        inner = {f: (slice(None),) * batched + interior[f]
                 for f in spec.persistent}

        def advance(carry, calls_, pc_):
            cur = {f: carry[f][inner[f]] for f in spec.persistent}
            if getattr(calls_[0], "returns_fields", False):
                # a chained sweep: one call advances every field by its
                # chain depth, updates included
                call = calls_[0]
                new = dict(cur)
                new.update(call({f: carry[f] for f in call.group_inputs},
                                svec, pc_[0],
                                input_pad={f: fpad[f]
                                           for f in call.group_inputs},
                                device=device))
            else:
                def resolve(call, f, env):
                    if f in carry:          # persistent: window from carry
                        return carry[f], fpad[f]
                    return bc.pad_field(env[f], call.halo_lo, call.halo_hi,
                                        bnd[f], align_hi=call.align_hi
                                        ).contiguous(), None

                outputs = _run_groups(p, calls_, svec, pc_, resolve, device)
                new = dict(cur)
                new.update(update(cur, outputs, upd_scalars))
            return write_back(carry, cur, new, inner, spec.carry_write,
                              bnd, refill)

        for _ in range(int(spec.steps) // chain):
            carry = advance(carry, calls, pc_per_call)
        if int(spec.steps) % chain:
            carry = advance(carry, epilogue, pc_epilogue)
        return {f: carry[f][inner[f]] for f in spec.persistent}

    run.calls = list(calls) + list(epilogue or [])
    return run
