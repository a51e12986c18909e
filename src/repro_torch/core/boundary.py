"""Boundary-condition subsystem on tensors: one place that knows how halos
are filled (the port of ``repro.core.boundary``).

* ``"zero"``      out-of-domain reads return 0 (``F.pad`` zero slabs).
* ``"periodic"``  the domain is a torus: out-of-domain reads wrap around
                  (``torch.roll`` / wrap-slices concatenated with
                  ``torch.cat``).

A field's boundary is one kind for every axis, or a tuple of kinds, one
per axis: ``("periodic", "periodic", "zero")`` is a doubly periodic domain,
wrapping along x and y, with a bounded z (a large-eddy model's surface and
lid).  :func:`normalize` turns a uniform tuple into its one kind, so the
same domain always reaches the same IR.

:func:`validate_boundaries` holds the one mixing rule, axis by axis: an op
producing a field periodic on axis ``a`` may only read fields periodic on
``a`` (and may only read a per-level coefficient along ``a`` when every
field is periodic on ``a``), so fused-group recompute can always reproduce
a periodic temp's wraparound values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

BOUNDARIES = ("zero", "periodic")


def normalize(spec):
    """``spec`` in its canonical form: a kind, or a tuple of per-axis kinds
    where they differ (a uniform sequence, such as a JSON list, becomes
    its one kind).  Anything else is returned as is, for
    :func:`validate_boundaries` to refuse."""
    if isinstance(spec, str) or not isinstance(spec, (list, tuple)):
        return spec
    kinds = tuple(spec)
    if kinds and all(k == kinds[0] for k in kinds) \
            and isinstance(kinds[0], str):
        return kinds[0]
    return kinds


def axis_kinds(spec, ndim: int) -> tuple:
    """The kind of each of ``ndim`` axes."""
    return (spec,) * ndim if isinstance(spec, str) else tuple(spec)


def is_periodic(spec, axis: int) -> bool:
    """Whether ``spec`` wraps along ``axis``."""
    return spec == "periodic" if isinstance(spec, str) \
        else spec[axis] == "periodic"


def any_periodic(spec) -> bool:
    """Whether ``spec`` wraps along some axis (its halo slabs then hold
    values of the field, which go stale when the field changes)."""
    return spec == "periodic" if isinstance(spec, str) \
        else "periodic" in spec


def spec_text(spec) -> str:
    """``spec`` as text: the kind, or the per-axis kinds joined by ``,``."""
    return spec if isinstance(spec, str) else ",".join(map(str, spec))


def validate_boundaries(p) -> None:
    """IR-level boundary checks (called from ``Program.validate``)."""
    for n, f in p.fields.items():
        kinds = f.boundary if isinstance(f.boundary, tuple) \
            else (f.boundary,)
        if isinstance(f.boundary, tuple) and len(kinds) != p.ndim:
            raise ValueError(
                f"field {n!r} has {len(kinds)} per-axis boundaries "
                f"{f.boundary!r}; the program is {p.ndim}-D")
        for k in kinds:
            if k not in BOUNDARIES:
                raise ValueError(
                    f"field {n!r} has unknown boundary {f.boundary!r}; "
                    "valid: " + ", ".join(repr(b) for b in BOUNDARIES)
                    + ", or a sequence of them, one per axis")
    for op in p.ops:
        out = p.fields[op.out].boundary
        for ax in range(p.ndim):
            if not is_periodic(out, ax):
                continue
            for a in op.accesses():
                if not is_periodic(p.fields[a.field].boundary, ax):
                    raise ValueError(
                        f"op {op.name or op.out!r} produces field "
                        f"{op.out!r}, periodic on axis {ax}, but reads "
                        f"{a.field!r}, which is not periodic on axis {ax}; "
                        "a periodic field's wraparound values cannot be "
                        "recomputed from zero-extended inputs")
            for c in op.coeff_refs():
                if p.coeffs[c.coeff] == ax and coeff_mode(p, ax) != "periodic":
                    raise ValueError(
                        f"op {op.name or op.out!r} produces field "
                        f"{op.out!r}, periodic on axis {ax}, and reads the "
                        f"per-level coefficient {c.coeff!r} along axis "
                        f"{ax}, but not every field is periodic on axis "
                        f"{ax} (a coefficient's wraparound is axis-global)")


def coeff_mode(p, axis: int | None = None) -> str:
    """How 1-D coefficient arrays along ``axis`` extend beyond the domain:
    they wrap only when every field is periodic on that axis, and
    zero-extend otherwise.  Without ``axis``: on every axis, so they wrap
    only on a full torus."""
    if axis is None:
        return "periodic" if p.is_torus() else "zero"
    return ("periodic" if all(is_periodic(f.boundary, axis)
                              for f in p.fields.values()) else "zero")


def _zero_pad(x: torch.Tensor, pads: Sequence[tuple]) -> torch.Tensor:
    """``jnp.pad``-style per-axis (lo, hi) zero padding."""
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):          # F.pad lists the last axis first
        flat += [int(lo), int(hi)]
    return F.pad(x, flat)


def pad_field(x: torch.Tensor, lo: Sequence[int], hi: Sequence[int],
              boundary, align_hi: Sequence[int] | None = None
              ) -> torch.Tensor:
    """Pad ``x`` with halo slabs per ``boundary`` plus a zero alignment slab.

    ``lo``/``hi`` are the per-axis halo widths of the last ``len(lo)`` axes
    (axes before them, such as a serving batch's, are not padded);
    ``align_hi`` (optional) is extra hi-side tile-alignment padding, always
    zero-filled — alignment positions are never read by in-domain
    consumers, only cropped or masked, so they need no wraparound values.
    A periodic halo wraps each batch element on its own.  A per-axis
    ``boundary`` wraps its periodic axes and zero-fills the others, axis
    by axis, so a corner slab is zero wherever one of its axes is.
    """
    ndim = len(lo)
    lead = x.ndim - ndim
    align_hi = tuple(align_hi) if align_hi is not None else (0,) * ndim
    if boundary == "zero":
        return _zero_pad(x, [(int(lo[a]), int(hi[a]) + int(align_hi[a]))
                             for a in range(ndim)])
    kinds = axis_kinds(boundary, ndim)
    for k in kinds:
        if k not in BOUNDARIES:
            raise ValueError(f"unknown boundary {boundary!r}")
    for ax in range(ndim):
        l, h, al = int(lo[ax]), int(hi[ax]), int(align_hi[ax])
        if l == 0 and h == 0 and al == 0:
            continue
        if kinds[ax] == "zero":
            x = _zero_pad(x, [(l, h + al) if a == ax else (0, 0)
                              for a in range(ndim)])
            continue
        dim = lead + ax
        n = x.shape[dim]
        if l > n or h > n:
            raise ValueError(
                f"periodic halo ({l},{h}) exceeds extent {n} on axis {ax}")
        pieces = []
        if l:
            pieces.append(x.narrow(dim, n - l, l))
        pieces.append(x)
        if h:
            pieces.append(x.narrow(dim, 0, h))
        if al:
            shp = list(x.shape)
            shp[dim] = al
            pieces.append(x.new_zeros(shp))
        x = torch.cat(pieces, dim=dim)
    return x


def shift_field(x: torch.Tensor, offset: Sequence[int], boundary
                ) -> torch.Tensor:
    """``out[i] = x[i + offset]`` with out-of-domain reads per ``boundary``
    (per axis: wrapped on its periodic axes, zero on the others)."""
    offset = tuple(int(o) for o in offset)
    if all(o == 0 for o in offset):
        return x
    kinds = axis_kinds(boundary, len(offset))
    for k in kinds:
        if k not in BOUNDARIES:
            raise ValueError(f"unknown boundary {boundary!r}")
    axes = tuple(ax for ax, o in enumerate(offset)
                 if o != 0 and kinds[ax] == "periodic")
    if axes:
        x = torch.roll(x, shifts=tuple(-offset[ax] for ax in axes),
                       dims=axes)
    offset = tuple(0 if kinds[ax] == "periodic" else o
                   for ax, o in enumerate(offset))
    if all(o == 0 for o in offset):
        return x
    h = max(abs(o) for o in offset)
    xp = _zero_pad(x, [(h, h)] * x.ndim)
    idx = tuple(slice(h + offset[ax], h + offset[ax] + x.shape[ax])
                for ax in range(x.ndim))
    return xp[idx]


def pad_coeff(c: torch.Tensor, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Extend a replicated 1-D coefficient array by (lo, hi) per ``mode``,
    along its last axis (a serving batch's ``(B, n)`` arrays extend each
    row).

    The wrap path gathers modular indices, so it stays correct even when
    the tile-alignment slab makes ``hi`` comparable to the array length.
    """
    lo, hi = int(lo), int(hi)
    if lo == 0 and hi == 0:
        return c
    if mode == "zero":
        return _zero_pad(c, [(lo, hi)])
    if mode != "periodic":
        raise ValueError(f"unknown boundary {mode!r}")
    n = c.shape[-1]
    return c[..., torch.arange(-lo, n + hi, device=c.device) % n]


def ring_perms(n: int, direction: int, periodic: bool) -> list:
    """The ``(source, destination)`` shard pairs of a one-shard shift
    along a mesh axis of ``n`` shards (the reference's ``ppermute``
    permutation).

    ``direction=+1`` sends each shard's slab to its right neighbour (fills
    *lo* halos), ``-1`` to its left (fills *hi* halos).  Periodic closes
    the ring; zero leaves the edge shard unreceiving, and its halo stays
    zero-filled — the zero-halo convention at the global edge.
    """
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1/-1, got {direction}")
    if periodic:
        return [(i, (i + direction) % n) for i in range(n)]
    if direction == 1:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i + 1, i) for i in range(n - 1)]
