"""The plain reference over a grid that no one card holds, run in slabs
along axis 0 and spread over the cell's cards.

A slab carries ``steps x reach`` ghost rows on each side that lies inside
the grid, cut from the inputs (``reach``: the rows along axis 0 that one
step of the scheme reads on either side). After ``steps`` steps only the
ghost rows have read past the slab, so the slab's interior holds exactly
what the whole-grid reference computes there: the same elementwise
operations on the same values, bit for bit. Slabs are advanced step by
step in turns, so that every card has work queued while the host moves on.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import compare

#: interior points of a slab: the one-card cells' whole grid, which the
#: reference is known to fit on a card
SLAB_POINTS = 2**27


def bounds(n: int, parts: int, ghost: int) -> list:
    """``(lo, a, b, hi)`` of each of ``parts`` slabs of ``n`` rows: the
    interior ``a:b`` and the rows ``lo:hi`` the slab computes, its ghosts
    cut at the grid's edges."""
    size = -(-n // parts)
    out = []
    for a in range(0, n, size):
        b = min(n, a + size)
        out.append((max(0, a - ghost), a, b, min(n, b + ghost)))
    return out


def _on(device):
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def plan(config: dict, grid, steps: int, devices,
         slab_points: int = SLAB_POINTS) -> list:
    """``(lo, a, b, hi, device)`` of each slab of ``grid``: at least one
    slab a device and at most ``slab_points`` interior points a slab,
    dealt over ``devices`` in turn."""
    rows = max(1, slab_points // math.prod(grid[1:]))
    parts = max(len(devices), -(-int(grid[0]) // rows))
    ghost = int(steps) * int(config["reference"]["reach"])
    return [(lo, a, b, hi, torch.device(devices[k % len(devices)]))
            for k, (lo, a, b, hi) in enumerate(bounds(int(grid[0]), parts,
                                                      ghost))]


def park(out: dict, names, slabs) -> dict:
    """The rows of each slab of :func:`plan` of the fields ``names`` of
    ``out``, moved to the slab's device: ``{(a, b): {field: rows}}``."""
    return {(a, b): {f: out[f][a:b].to(dev) for f in names}
            for _, a, b, _, dev in slabs}


def run(ref, config: dict, fields: dict, scalars: dict, coeffs: dict,
        steps: int, slabs, dtypes=(torch.float32,)) -> list:
    """The reference module ``ref`` of ``config`` over ``fields`` in the
    slabs of :func:`plan`: ``[(a, b, {dtype: {field: rows a:b}})]``, each
    slab's results on its device."""
    rc = config["reference"]
    args = rc.get("args", {})
    state = []
    for lo, a, b, hi, dev in slabs:
        f = {n: v[lo:hi].to(dev) for n, v in fields.items()}
        c = {n: v.to(dev) for n, v in coeffs.items()}
        state.append((dev, c, {d: f for d in dtypes}))
    for _ in range(int(steps)):
        for dev, c, res in state:
            with _on(dev):
                for d in dtypes:
                    res[d] = ref.run(rc["scheme"], res[d], scalars, c, 1,
                                     dtype=d, **args)
    return [(a, b, {d: {n: v[a - lo:b - lo] for n, v in res[d].items()}
                    for d in dtypes})
            for (lo, a, b, _, _), (_, _, res) in zip(slabs, state)]


def errors(results, names, got) -> dict:
    """Per field of ``names``, :func:`compare.error_parts` of each slab of
    :func:`run`'s ``results``: ``got(a, b, res)`` gives the compared
    fields' rows ``a:b``, held against the slab's float32 rows."""
    out = {f: [] for f in names}
    for a, b, res in results:
        want = res[torch.float32]
        g = got(a, b, res)
        dev = want[names[0]].device
        with _on(dev):
            for f in names:
                out[f].append(compare.error_parts(g[f].to(dev), want[f]))
    return out
