"""Plain PyTorch reference of the paper's two advection programs on a
doubly periodic domain: the domain of MONC's large-eddy cases (BOMEX, the
GCSS ARM case), which wraps along x and y and is bounded along z by the
surface and the lid.

The equations are those of ``bench/reference/advection.py``, written out
again here; only the read at an offset differs: it wraps along axes 0 and
1 (x and y, ``torch.roll``) and is zero outside the grid along axis 2 (z).
A per-level coefficient is read at its own level. Every intermediate is a
whole tensor of the grid's shape; nothing is fused, tiled or cached.

Imports nothing of the program under test. ``run`` has the signature of
``advection.run``: float32 is the configuration's precision, and bfloat16
the lower-precision control that the benchmark's limits must reject.
"""

from __future__ import annotations

import torch


def shift(x: torch.Tensor, off) -> torch.Tensor:
    """``out[i] = x[i + off]``, wrapped along axes 0 and 1, zero where
    ``i + off`` leaves the grid along axis 2."""
    i, j, k = (int(o) for o in off)
    if i or j:
        x = torch.roll(x, shifts=(-i, -j), dims=(0, 1))
    out = torch.zeros_like(x)
    n = x.shape[2]
    if abs(k) >= n:
        return out
    out[:, :, max(0, -k):n - max(0, k)] = x[:, :, max(0, k):n - max(0, -k)]
    return out


def _at(ax: int, o: int) -> tuple:
    return tuple(o if a == ax else 0 for a in range(3))


def _level(c: torch.Tensor) -> torch.Tensor:
    """A per-level (axis 2) coefficient, shaped to broadcast over a grid."""
    return c.reshape(1, 1, -1)


def pw_sources(f: dict, s: dict, c: dict) -> dict:
    """The three momentum source terms su, sv, sw of one step."""
    u, v, w = f["u"], f["v"], f["w"]
    tcx, tcy = s["tcx"], s["tcy"]
    tzc1, tzc2 = _level(c["tzc1"]), _level(c["tzc2"])
    tzd1, tzd2 = _level(c["tzd1"]), _level(c["tzd2"])

    def sh(x, i, j, k):
        return shift(x, (i, j, k))

    su = (tcx * (sh(u, -1, 0, 0) * (u + sh(u, -1, 0, 0))
                 - u * (sh(u, 1, 0, 0) + u))
          + tcy * (sh(u, 0, -1, 0) * (sh(v, 0, -1, 0) + sh(v, 1, -1, 0))
                   - u * (v + sh(v, 1, 0, 0)))
          + tzc1 * sh(u, 0, 0, -1) * (sh(w, 0, 0, -1) + sh(w, 1, 0, -1))
          - tzc2 * u * (w + sh(w, 1, 0, 0)))
    sv = (tcx * (sh(v, -1, 0, 0) * (sh(u, -1, 0, 0) + sh(u, -1, 1, 0))
                 - v * (u + sh(u, 0, 1, 0)))
          + tcy * (sh(v, 0, -1, 0) * (v + sh(v, 0, -1, 0))
                   - v * (sh(v, 0, 1, 0) + v))
          + tzc1 * sh(v, 0, 0, -1) * (sh(w, 0, 0, -1) + sh(w, 0, 1, -1))
          - tzc2 * v * (w + sh(w, 0, 1, 0)))
    sw = (tcx * (sh(w, -1, 0, 0) * (sh(u, -1, 0, 0) + sh(u, -1, 0, 1))
                 - w * (u + sh(u, 0, 0, 1)))
          + tcy * (sh(w, 0, -1, 0) * (sh(v, 0, -1, 0) + sh(v, 0, -1, 1))
                   - w * (v + sh(v, 0, 0, 1)))
          + tzd1 * sh(w, 0, 0, -1) * (w + sh(w, 0, 0, -1))
          - tzd2 * w * (sh(w, 0, 0, 1) + w))
    return {"su": su, "sv": sv, "sw": sw}


def pw_step(f: dict, s: dict, c: dict, dt: float) -> dict:
    """One forward-Euler step of the winds."""
    src = pw_sources(f, s, c)
    return dict(f, u=f["u"] + dt * src["su"], v=f["v"] + dt * src["sv"],
                w=f["w"] + dt * src["sw"])


def _limited(d: torch.Tensor, ax: int) -> torch.Tensor:
    """Minmod of a slope and its upstream neighbour along ``ax``."""
    dm = shift(d, _at(ax, -1))
    return torch.where(d * dm > 0.0,
                       torch.sign(d) * torch.minimum(d.abs(), dm.abs()),
                       torch.zeros_like(d))


def _flux(x: torch.Tensor, vel: torch.Tensor, sl: torch.Tensor,
          ax: int) -> torch.Tensor:
    """Upwind flux of ``x`` with limited slopes ``sl`` along ``ax``."""
    up = shift(x, _at(ax, -1))
    sm = shift(sl, _at(ax, -1))
    return torch.where(vel > 0.0, vel * (up + 0.5 * sm),
                       vel * (x - 0.5 * sl))


def _slopes(x: torch.Tensor, msk: torch.Tensor) -> list:
    return [_limited((shift(x, _at(ax, 1)) - x) * msk, ax)
            for ax in range(3)]


def tracer_step(f: dict, s: dict, c: dict) -> dict:
    """One predictor-corrector MUSCL step of the tracer ``t``; the
    velocities, the cell thicknesses and the mask are steady."""
    t, msk = f["t"], f["msk"]
    vel = (f["un"], f["vn"], f["wn"])
    rdt = s["rdt"]
    thick = f["e3t"] + s["zeps"]
    sl = _slopes(t, msk)
    div = None
    for ax in range(3):
        fl = _flux(t, vel[ax], sl[ax], ax)
        d = (shift(fl, _at(ax, 1)) - fl) / thick
        div = d if div is None else div + d
    del sl
    ta1 = torch.maximum(t - rdt * div, _level(c["ztfreez"]))
    sl = _slopes(ta1, msk)
    acc = None
    for ax in range(3):
        fl = _flux(ta1, vel[ax], sl[ax], ax)
        d = shift(fl, _at(ax, 1)) - fl
        acc = d if acc is None else acc + d
    del sl
    ta = (0.5 * (t + ta1) - 0.5 * rdt * (acc / thick)) * msk
    return dict(f, t=ta)


def run(scheme: str, fields: dict, scalars: dict, coeffs: dict, steps: int,
        dtype: torch.dtype = torch.float32, dt: float = 0.1) -> dict:
    """``steps`` steps of ``scheme`` ("pw" or "tracer") from ``fields``,
    computed in ``dtype``; returns every field after the last step."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f = {k: v.to(dtype) for k, v in fields.items()}
            c = {k: v.to(dtype) for k, v in coeffs.items()}
            s = {k: float(v) for k, v in scalars.items()}
            for _ in range(int(steps)):
                if scheme == "pw":
                    f = pw_step(f, s, c, dt)
                elif scheme == "tracer":
                    f = tracer_step(f, s, c)
                else:
                    raise ValueError(f"unknown scheme {scheme!r}")
            return f
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
