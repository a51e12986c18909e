"""Kernel backend orchestrator: Program + DataflowPlan -> executable (the
port of ``repro.core.lower_pallas``).

Runs the plan's fuse groups in order, each as its generated CUDA kernel
(:mod:`repro_torch.kernels.stencil3d`; the kernel's plain PyTorch version
on CPU tensors).  Fields crossing a group boundary are materialised in
device memory and re-padded for the consuming group's windows.  All groups
of one compiled program share one translation unit, built by one ``nvcc``
call on first launch.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..kernels.stencil3d import bind, build_group_call
from . import boundary as bc
from .ir import Program
from .lower_torch import write_back
from .schedule import DataflowPlan, TimeLoopSpec, adapt_update

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def _pad_coeffs(p: Program, calls, coeffs, dtype, device):
    """Per-call padded coefficient arrays ('small data', paper step 8)."""
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
                origin=None):
    """Run the fuse groups in order, materialising inter-group fields.

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
        res = call(padded, svec, pc, input_pad=ipad or None, origin=origin)
        env.update(res)
        for f, v in res.items():
            if p.fields[f].role.value == "output":
                outputs[f] = v
    return outputs


def _scalar_vec(p: Program, scalars) -> list:
    """Runtime scalars as float32-rounded host floats, in program order."""
    return [float(torch.as_tensor(scalars[s], dtype=torch.float32))
            for s in p.scalars]


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
            coeffs: Mapping | None = None):
        scalars = scalars or {}
        coeffs = coeffs or {}
        ext = {k: torch.as_tensor(v, dtype=dtype, device=device)
               for k, v in fields.items()}
        bnd = p.boundaries()

        def resolve(call, f, env):
            x = env[f] if f in env else ext[f]
            return bc.pad_field(x, call.halo_lo, call.halo_hi, bnd[f],
                                align_hi=call.align_hi).contiguous(), None

        return _run_groups(p, calls, _scalar_vec(p, scalars),
                           _pad_coeffs(p, calls, coeffs, dtype, device),
                           resolve)

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
                         update, calls, device):
    """Fused-loop orchestrator over prebuilt kernel calls."""
    update = adapt_update(update)
    ndim = p.ndim
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
            coeffs: Mapping | None = None):
        scalars = scalars or {}
        coeffs = coeffs or {}
        svec = _scalar_vec(p, scalars)
        pc_per_call = _pad_coeffs(p, calls, coeffs, dtype, device)
        carry = {f: refill(f, torch.as_tensor(fields[f], dtype=dtype,
                                              device=device))
                 for f in spec.persistent}

        def resolve(call, f, env):
            if f in carry:              # persistent: window from carry
                return carry[f], fpad[f]
            return bc.pad_field(env[f], call.halo_lo, call.halo_hi,
                                bnd[f], align_hi=call.align_hi
                                ).contiguous(), None

        for _ in range(int(spec.steps)):
            outputs = _run_groups(p, calls, svec, pc_per_call, resolve)
            cur = {f: carry[f][interior[f]] for f in spec.persistent}
            new = dict(cur)
            new.update(update(cur, outputs, scalars))
            carry = write_back(carry, cur, new, interior, spec.carry_write,
                               bnd, refill)
        return {f: carry[f][interior[f]] for f in spec.persistent}

    run.calls = calls
    return run
