"""Seeded inputs, made on the device in one large draw a tensor.

A configuration's ``inputs`` lists each field, scalar and coefficient. A
field or coefficient is a standard normal draw followed by its ``ops``,
applied in order: ``["mul", a]``, ``["add", a]``, ``["abs"]`` and
``["positive"]`` (1 where the value is above 0, else 0). Draws follow the
order of the configuration's lists, fields first, from one generator
seeded with ``seed``: the same seed gives the same inputs.
"""

from __future__ import annotations

import torch


def _apply(x: torch.Tensor, ops) -> torch.Tensor:
    for op in ops:
        kind = op[0]
        if kind == "mul":
            x = x * float(op[1])
        elif kind == "add":
            x = x + float(op[1])
        elif kind == "abs":
            x = x.abs()
        elif kind == "positive":
            x = (x > 0).to(x.dtype)
        else:
            raise ValueError(f"unknown input op {kind!r}")
    return x


def make(config: dict, grid, seed: int, device) -> tuple:
    """``(fields, scalars, coeffs)`` for ``config`` on ``grid``: float32
    tensors on ``device``, and the scalars as floats."""
    spec = config["inputs"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    grid = tuple(int(g) for g in grid)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    fields = {f: _apply(normal(grid), ops)
              for f, ops in spec["fields"].items()}
    coeffs = {c: _apply(normal((grid[d["axis"]],)), d["ops"])
              for c, d in spec["coeffs"].items()}
    scalars = {s: float(v) for s, v in spec["scalars"].items()}
    return fields, scalars, coeffs
