"""Shape bucketing for the serving layer — exact execution on padded grids
(the port of ``repro.serve.bucket``).

The engine compiles each program once per *bucket* (a quantised grid
shape) and runs every request whose grid rounds up to that bucket through
the same compiled executor.  Correctness does not come from masking the
final answer — ghost cells would contaminate the interior one halo per
fused step — but from an invariant maintained jointly by three pieces:

1. **Placement** (:func:`repro_torch.core.schedule.bucket_for`): the real
   grid ``G`` sits at offset ``off = lo`` (the program's low reach) inside
   a bucket ``B >= G + lo + hi``, so no read issued *for an in-domain
   cell* ever crosses the bucket edge.  The compiled program's own
   boundary handling at bucket edges is therefore never observed by real
   cells.
2. **Embedding** (:func:`embed_field` / :func:`embed_coeff`, host-side
   numpy): on request ingress every bucket cell — not just the reach ring
   — is filled with the value the real boundary dictates (0, or the torus
   wrap of the interior).
3. **Refresh** (:func:`make_refresh`, installed by :func:`wrap_update`):
   after every fused step the out-of-domain cells are rewritten from the
   new interior, on the device, restoring the embedding before the next
   step reads it.
4. **Domain** (:func:`repro_torch.core.schedule.serving_domain`): within a
   step, every zero-boundary op of a serving program reads as 0 outside
   the element's real domain, as it does outside the exact grid.  The
   reference has no such piece: its temps, computed over the whole
   bucket, give a consumer at the domain's edge other values than the
   exact grid does wherever an op reads in-domain cells from outside the
   domain (tracer_advection; pw_advection's ops read only inputs).

Real grid sizes enter the executable as runtime scalars (``_srv_n0`` …
appended to ``p.scalars`` by :func:`serving_program`), so every grid that
rounds to the same bucket shares one compiled executable and one set of
kernel sources, and the sizes differ per element of a batch (``(B,)``
tensors, one row of the kernels' scalar array an element).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import boundary as bc
from ..core.ir import Program
from ..core.schedule import (SIZE_SCALAR_PREFIX, BucketSpec,  # noqa: F401
                             adapt_update, bucket_for)


def size_scalar_names(ndim: int) -> list:
    return [f"{SIZE_SCALAR_PREFIX}{a}" for a in range(ndim)]


def serving_program(p: Program) -> Program:
    """A copy of ``p`` with per-axis grid-size scalars appended.

    Appending (never inserting) keeps existing scalar indices stable for
    the kernels' scalar rows.  Idempotent: a program that already carries
    the size scalars is returned unchanged.  A program with a per-axis
    boundary (a field that wraps on some axes only) is refused: the
    embedding and the refresh fill each field's bucket cells by one kind.
    """
    mixed = sorted(n for n, f in p.fields.items()
                   if isinstance(f.boundary, tuple))
    if mixed:
        raise ValueError(
            f"serving fields with a per-axis boundary {mixed} "
            f"({bc.spec_text(p.fields[mixed[0]].boundary)}) is not "
            "supported: the bucket embedding and refresh fill a field's "
            "cells by one kind on every axis; compile it with "
            "compile_program instead")
    names = size_scalar_names(p.ndim)
    if all(n in p.scalars for n in names):
        return p
    clash = [n for n in p.scalars if n.startswith(SIZE_SCALAR_PREFIX)]
    if clash:
        raise ValueError(f"program scalars {clash} collide with the "
                         f"serving size-scalar prefix {SIZE_SCALAR_PREFIX!r}")
    sp = Program(name=p.name, ndim=p.ndim, fields=dict(p.fields),
                 scalars=list(p.scalars) + names, ops=list(p.ops),
                 coeffs=dict(p.coeffs))
    sp.validate()
    return sp


def size_scalars(spec: BucketSpec) -> dict:
    return {f"{SIZE_SCALAR_PREFIX}{a}": float(g)
            for a, g in enumerate(spec.grid)}


# --------------------------------------------------------------------------
# Host-side embed / crop (request ingress and egress)
# --------------------------------------------------------------------------


def embed_field(x, spec: BucketSpec, boundary: str) -> np.ndarray:
    """Place a real-grid array into its bucket, filling every out-of-domain
    cell per the field's boundary (zeros, or the torus wrap of ``x``)."""
    x = np.asarray(x)
    if tuple(x.shape) != tuple(spec.grid):
        raise ValueError(f"field shape {x.shape} != request grid {spec.grid}")
    if boundary == "periodic":
        idxs = [(np.arange(b) - o) % g
                for g, b, o in zip(spec.grid, spec.bucket, spec.offset)]
        return x[np.ix_(*idxs)]
    out = np.zeros(spec.bucket, dtype=x.dtype)
    out[spec.interior()] = x
    return out


def embed_coeff(c, axis: int, spec: BucketSpec, mode: str) -> np.ndarray:
    """Extend a per-axis coefficient array to bucket length.

    ``mode`` must match :func:`repro_torch.core.boundary.coeff_mode` for
    the program so the embedded values agree with what the exact-grid
    compile would read through its shifted-coefficient path.
    """
    c = np.asarray(c)
    g, b, o = spec.grid[axis], spec.bucket[axis], spec.offset[axis]
    if c.shape != (g,):
        raise ValueError(f"coeff shape {c.shape} != ({g},) on axis {axis}")
    if mode == "periodic":
        return c[(np.arange(b) - o) % g]
    out = np.zeros(b, dtype=c.dtype)
    out[o:o + g] = c
    return out


def crop(x, spec: BucketSpec):
    """Slice the real-grid interior back out of a bucket-shaped array."""
    return x[spec.interior()]


def embed_request(p: Program, spec: BucketSpec, fields, scalars=None,
                  coeffs=None):
    """Embed one request's arrays and attach the size scalars.

    Returns (fields, scalars, coeffs) dicts shaped for the bucket compile.
    """
    bnd = p.boundaries()
    cmode = bc.coeff_mode(p)
    efields = {f: embed_field(x, spec, bnd[f]) for f, x in fields.items()}
    escalars = dict(scalars or {})
    escalars.update(size_scalars(spec))
    ecoeffs = {c: embed_coeff(x, p.coeffs[c], spec, cmode)
               for c, x in (coeffs or {}).items()}
    return efields, escalars, ecoeffs


# --------------------------------------------------------------------------
# Device-side refresh (re-establish the embedding after each fused step)
# --------------------------------------------------------------------------


def make_refresh(p: Program, spec: BucketSpec):
    """Build ``refresh(fields, scalars) -> fields`` rewriting out-of-domain
    bucket cells from the per-request grid sizes.

    Fields are bucket-shaped, or ``(B, *bucket)`` for a batch; the sizes
    come from the ``_srv_n*`` scalars, a number or 0-d tensor for one
    request and ``(B, 1, ..., 1)`` (or ``(B,)``) for a batch, so every
    element keeps its own grid.  Periodic fields gather
    ``x[off + (i - off) mod n]`` along each axis, from a ``(B, bucket_a)``
    index an axis, in one indexing pass; zero fields keep the cells inside
    ``[off, off + n)`` on every axis, one mask for all of them.

    Under a mesh the refresh sees each shard's *local* block, and
    ``origin`` (the shard's global offset, which the distributed fused
    loop passes) shifts the zero masks into global coordinates; periodic
    fields reject it, since the gather is a whole-axis permutation with no
    shard-local form (the engine refuses such requests first).
    """
    bnd = p.boundaries()
    names = size_scalar_names(p.ndim)
    offs = tuple(int(o) for o in spec.offset)
    nd = p.ndim

    def refresh(fields, scalars, origin=None):
        out, per_axis = {}, None
        for f, x in fields.items():
            one = x.ndim == nd            # a single request: a batch of 1
            xb = x.unsqueeze(0) if one else x
            B, dev = xb.shape[0], x.device
            if per_axis is None:
                ns = [torch.as_tensor(scalars[nm], device=dev).reshape(-1)
                      .to(torch.int64).expand(B) for nm in names]
                # index a (B, n_a) array an axis, shaped to broadcast
                # against (B, *bucket)
                per_axis = []
                for a in range(nd):
                    shape = [B] + [1] * nd
                    shape[1 + a] = xb.shape[1 + a]
                    i = torch.arange(xb.shape[1 + a], device=dev)[None, :]
                    per_axis.append((shape, i, ns[a][:, None]))
            if bnd.get(f) == "periodic":
                if origin is not None:
                    raise NotImplementedError(
                        f"periodic field {f!r}: the bucket refresh is a "
                        "global torus gather with no shard-local form; "
                        "serve periodic fused loops unsharded")
                idx = [torch.arange(B, device=dev).reshape([B] + [1] * nd)]
                idx += [(offs[a] + (i - offs[a]) % n).reshape(shape)
                        for a, (shape, i, n) in enumerate(per_axis)]
                xb = xb[tuple(idx)]
            else:
                mask = None
                for a, (shape, i, n) in enumerate(per_axis):
                    if origin is not None:
                        i = i + int(origin[a])
                    inb = ((i >= offs[a]) & (i < offs[a] + n)).reshape(shape)
                    mask = inb if mask is None else mask & inb
                xb = torch.where(mask, xb, torch.zeros((), dtype=xb.dtype,
                                                       device=dev))
            out[f] = xb[0] if one else xb
        return out

    return refresh


def wrap_update(p: Program, spec: BucketSpec, update):
    """Wrap a user update rule for bucketed fused-loop execution.

    The wrapped rule runs the user's update on the bucket-shaped fields,
    then refreshes the out-of-domain cells so step ``t+1`` reads the same
    embedding step ``t`` did.  (The reference counts the rule's JAX traces
    here; the port runs it eagerly each step, and the engine counts kernel
    builds instead.)
    """
    user = adapt_update(update)
    refresh = make_refresh(p, spec)

    def wrapped(fields, outputs, scalars, origin=None):
        new = dict(fields)
        new.update(user(fields, outputs, scalars))
        return refresh(new, scalars, origin)

    wrapped._takes_scalars = True
    # the sharded time loop feeds each shard's global offset so the
    # refresh masks in global coordinates
    wrapped._takes_origin = True
    # the refresh gathers across whole bucket axes — there is no plane-local
    # form, so stream compiles must not chain this update into the kernel
    wrapped._plane_local = False
    return wrapped
