"""Boundary-condition subsystem on tensors: one place that knows how halos
are filled (the port of ``repro.core.boundary``).

* ``"zero"``      out-of-domain reads return 0 (``F.pad`` zero slabs).
* ``"periodic"``  the domain is a torus: out-of-domain reads wrap around
                  (``torch.roll`` / wrap-slices concatenated with
                  ``torch.cat``).

:func:`validate_boundaries` holds the one mixing rule: an op producing a
*periodic* field may only read periodic fields (and may only use
per-level coefficients on a full torus), so fused-group recompute can
always reproduce a periodic temp's wraparound values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

BOUNDARIES = ("zero", "periodic")


def validate_boundaries(p) -> None:
    """IR-level boundary checks (called from ``Program.validate``)."""
    for n, f in p.fields.items():
        if f.boundary not in BOUNDARIES:
            raise ValueError(
                f"field {n!r} has unknown boundary {f.boundary!r}; valid: "
                + ", ".join(repr(b) for b in BOUNDARIES))
    torus = all(f.boundary == "periodic" for f in p.fields.values())
    for op in p.ops:
        if p.fields[op.out].boundary != "periodic":
            continue
        for a in op.accesses():
            if p.fields[a.field].boundary != "periodic":
                raise ValueError(
                    f"op {op.name or op.out!r} produces periodic field "
                    f"{op.out!r} but reads zero-boundary field {a.field!r}; "
                    "a periodic field's wraparound values cannot be "
                    "recomputed from zero-extended inputs")
        if op.coeff_refs() and not torus:
            raise ValueError(
                f"op {op.name or op.out!r} produces periodic field "
                f"{op.out!r} and reads per-level coefficients, but the "
                "program is not a full torus (coefficient wraparound is "
                "axis-global)")


def coeff_mode(p) -> str:
    """How 1-D coefficient arrays extend beyond the domain: they wrap only
    on a full torus (every field periodic), zero-extend otherwise."""
    return "periodic" if p.is_torus() else "zero"


def _zero_pad(x: torch.Tensor, pads: Sequence[tuple]) -> torch.Tensor:
    """``jnp.pad``-style per-axis (lo, hi) zero padding."""
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):          # F.pad lists the last axis first
        flat += [int(lo), int(hi)]
    return F.pad(x, flat)


def pad_field(x: torch.Tensor, lo: Sequence[int], hi: Sequence[int],
              boundary: str, align_hi: Sequence[int] | None = None
              ) -> torch.Tensor:
    """Pad ``x`` with halo slabs per ``boundary`` plus a zero alignment slab.

    ``lo``/``hi`` are the per-axis halo widths of the last ``len(lo)`` axes
    (axes before them, such as a serving batch's, are not padded);
    ``align_hi`` (optional) is extra hi-side tile-alignment padding, always
    zero-filled — alignment positions are never read by in-domain
    consumers, only cropped or masked, so they need no wraparound values.
    A periodic halo wraps each batch element on its own.
    """
    ndim = len(lo)
    lead = x.ndim - ndim
    align_hi = tuple(align_hi) if align_hi is not None else (0,) * ndim
    if boundary == "zero":
        return _zero_pad(x, [(int(lo[a]), int(hi[a]) + int(align_hi[a]))
                             for a in range(ndim)])
    if boundary != "periodic":
        raise ValueError(f"unknown boundary {boundary!r}")
    for ax in range(ndim):
        l, h, al = int(lo[ax]), int(hi[ax]), int(align_hi[ax])
        if l == 0 and h == 0 and al == 0:
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


def shift_field(x: torch.Tensor, offset: Sequence[int], boundary: str
                ) -> torch.Tensor:
    """``out[i] = x[i + offset]`` with out-of-domain reads per ``boundary``."""
    offset = tuple(int(o) for o in offset)
    if all(o == 0 for o in offset):
        return x
    if boundary == "periodic":
        axes = tuple(ax for ax, o in enumerate(offset) if o != 0)
        return torch.roll(x, shifts=tuple(-offset[ax] for ax in axes),
                          dims=axes)
    if boundary != "zero":
        raise ValueError(f"unknown boundary {boundary!r}")
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
