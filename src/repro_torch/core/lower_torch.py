"""Pure-torch lowerings — the port's reference backends and CPU oracle (the
port of ``repro.core.lower_jnp``).

* ``naive`` — each op traverses full tensors independently, every access is
  a fresh zero-padded (or wrapped) shift, no reuse structure.
* ``fused`` — ops evaluated with one shared memo across the whole program,
  so repeated subtrees and repeated accesses evaluate once.

SSA discipline (every field written exactly once, enforced by the builder)
makes the shared memo sound: an Access never goes stale.
"""

from __future__ import annotations

from typing import Mapping

import torch

from . import boundary as bc
from .expr_eval import evaluate
from .ir import Access, FieldRole, Program


def scalar_tensors(p: Program, scalars: Mapping, device) -> dict:
    """Runtime scalars as 0-d float32 tensors on ``device`` (a float32
    scalar never widens a float32 or bfloat16 field computation)."""
    out = {}
    for s in p.scalars:
        v = scalars[s]
        out[s] = (v.to(device=device, dtype=torch.float32).reshape(())
                  if isinstance(v, torch.Tensor)
                  else torch.tensor(float(v), dtype=torch.float32,
                                    device=device))
    return out


def lower(p: Program, mode: str = "fused", prepad: Mapping | None = None):
    """Return fn(fields, scalars, coeffs) -> dict of output tensors.

    With ``prepad`` (field name -> (ndim, 2) halo widths) the external input
    fields must arrive *already padded* by those amounts (halo slabs filled
    per the field's boundary by the caller); every Access then resolves to a
    slice view of the persistent padded buffer instead of a fresh pad — the
    access path the fused time loop uses for its carry-resident fields.
    Temps produced mid-program stay interior-shaped and keep the
    shift-on-access path, which honours each field's declared boundary.
    """
    if mode not in ("naive", "fused"):
        raise ValueError(mode)
    prepadded = set(prepad or {})
    bnd = p.boundaries()
    cmode = bc.coeff_mode(p)

    def run(fields: Mapping[str, torch.Tensor],
            scalars: Mapping | None = None,
            coeffs: Mapping[str, torch.Tensor] | None = None):
        scalars = scalars or {}
        coeffs = coeffs or {}
        env = dict(fields)
        outputs = {}
        shared_memo: dict = {}
        any_field = next(iter(fields.values()))
        svals = scalar_tensors(p, scalars, any_field.device)
        if prepad is None:
            interior = tuple(any_field.shape)
        else:
            fref = next(f for f in fields if f in prepadded)
            h = prepad[fref]
            interior = tuple(fields[fref].shape[ax]
                             - int(h[ax, 0]) - int(h[ax, 1])
                             for ax in range(p.ndim))

        def coeff(c):
            ax = p.coeffs[c.coeff]
            v = bc.shift_field(coeffs[c.coeff], (c.offset,), cmode)
            shape = [1] * p.ndim
            shape[ax] = v.shape[0]
            return v.reshape(shape)

        for op in p.ops:
            memo = shared_memo if mode == "fused" else {}

            def access(a: Access):
                if a.field in prepadded:
                    h = prepad[a.field]
                    sl = tuple(slice(int(h[ax, 0]) + int(a.offset[ax]),
                                     int(h[ax, 0]) + int(a.offset[ax])
                                     + interior[ax])
                               for ax in range(p.ndim))
                    return env[a.field][sl]
                return bc.shift_field(env[a.field], a.offset, bnd[a.field])

            res = evaluate(op.expr, access, svals.__getitem__, memo,
                           coeff=coeff)
            if not isinstance(res, torch.Tensor):
                res = torch.tensor(res, dtype=any_field.dtype,
                                   device=any_field.device)
            res = res.expand(interior)
            env[op.out] = res
            if p.fields[op.out].role == FieldRole.OUTPUT:
                outputs[op.out] = res
        return outputs

    return run


def lower_time_loop(p: Program, mode: str, spec, update):
    """Return fn(fields, scalars, coeffs) -> final fields after
    ``spec.steps`` iterations.

    The loop keeps the persistent input fields pre-padded by
    ``spec.field_pad``; every step reads windows out of the padded buffers
    (slice views, no fresh pad) and ``update(fields, outputs)`` produces the
    new interiors.  Halo slabs follow each field's boundary: zero slabs
    stay zero throughout (``carry_write="inplace"`` copies only the new
    interior into the buffer, in place); periodic slabs — and every slab
    under ``"repad"`` — are rebuilt from the new interior each step.
    """
    from .schedule import adapt_update

    update = adapt_update(update)
    fpad = spec.field_pad
    bnd = p.boundaries()
    step_fn = lower(p, mode, prepad=fpad)

    def run(fields: Mapping, scalars: Mapping | None = None,
            coeffs: Mapping | None = None):
        scalars = dict(scalars or {})
        coeffs = dict(coeffs or {})
        ndim = p.ndim
        shape = next(iter(fields.values())).shape
        interior = {f: tuple(slice(int(fpad[f][a, 0]),
                                   int(fpad[f][a, 0]) + shape[a])
                             for a in range(ndim))
                    for f in spec.persistent}

        def refill(f, x):
            return bc.pad_field(x, fpad[f][:, 0], fpad[f][:, 1], bnd[f])

        carry = {f: refill(f, fields[f]) for f in spec.persistent}
        for _ in range(int(spec.steps)):
            outs = step_fn(carry, scalars, coeffs)
            cur = {f: carry[f][interior[f]] for f in spec.persistent}
            new = dict(cur)
            new.update(update(cur, outs, scalars))
            carry = write_back(carry, cur, new, interior, spec.carry_write,
                               bnd, refill)
        return {f: carry[f][interior[f]] for f in spec.persistent}

    return run


def write_back(carry: dict, cur: dict, new: dict, interior: dict,
               carry_write: str, bnd: dict, refill) -> dict:
    """Write one step's new field interiors into the loop carry.

    ``"inplace"`` on a zero-boundary field copies the new interior into the
    existing buffer (``copy_`` into the interior view; the zero halo slabs
    never change), skipping fields the update left unchanged.  Everything
    else is rebuilt: interior plus constant zero or refreshed wraparound
    halo slabs, in a new buffer.  New values that alias a carry buffer are
    cloned first, so no in-place write can clobber a value still to be
    read.
    """
    bases = {carry[f].untyped_storage().data_ptr() for f in carry}
    vals = {}
    for f in carry:
        v = new[f]
        if (carry_write == "inplace" and v is not cur[f]
                and v.untyped_storage().data_ptr() in bases):
            v = v.clone()
        vals[f] = v
    out = {}
    for f in carry:
        v = vals[f]
        if carry_write == "inplace" and bnd[f] == "zero":
            if v is not cur[f]:
                carry[f][interior[f]].copy_(v)
            out[f] = carry[f]
        else:
            out[f] = refill(f, v.to(carry[f].dtype))
    return out
