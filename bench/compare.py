"""The comparison that decides ``correct``.

A call's fields after its steps are held against the reference's: for
each field the update changes, the largest absolute difference over the
reference's largest absolute value, each taken over the whole grid or
slab by slab (``bench/slabs.py``) and combined. Each call of the window
is also held to the compared call bit for bit, through a digest of its
changed fields (every call starts from the same inputs). Each number has its limit from
the cell's file under ``bench/limits/``.
"""

from __future__ import annotations

import math

import torch


#: elements a digest sums at once: a field of the one-card cells (2**27
#: points) is one chunk; a larger one is summed in slabs along axis 0, so
#: that its 64-bit copy never takes a field's size
DIGEST_CHUNK = 2**27


def digest(torch, fields: dict, names,
           chunk: int = DIGEST_CHUNK) -> "torch.Tensor":
    """Per field, the sum of its elements' bit patterns as 64-bit
    integers: any changed bit changes it. Integer sums are exact, so the
    chunks give the one-pass sum."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}

    def one(x):
        x = x.view(bits[x.element_size()])
        rows = max(1, chunk * x.shape[0] // max(1, x.numel()))
        total = None
        for i in range(0, x.shape[0], rows):
            part = x[i:i + rows].sum(dtype=torch.int64)
            total = part if total is None else total + part
        return total

    return torch.stack([one(fields[f]) for f in names])


def error_parts(got, want) -> tuple:
    """``(max|got - want|, max|want|)`` as 0-d tensors on ``want``'s
    device: what :func:`rel_err` divides, taken slab by slab."""
    g, w = got.float(), want.float()
    return (g - w).abs().max(), w.abs().max()


def rel_err_of_parts(parts) -> float:
    """:func:`rel_err` of a field from its slabs' :func:`error_parts`: the
    largest difference over the largest value (a NaN in either stays)."""
    err = float(torch.stack([e.cpu() for e, _ in parts]).max())
    scale = float(torch.stack([m.cpu() for _, m in parts]).max())
    if scale > 0:
        return err / scale
    return 0.0 if err == 0 else math.inf


def rel_err(got, want) -> float:
    """:func:`rel_err_of_parts` of a whole field."""
    return rel_err_of_parts([error_parts(got, want)])


def checks(parts: dict, writes, limits: dict, calls_off: int) -> list:
    """``[(name, value, limit)]`` of every number compared: ``parts``
    holds each changed field's :func:`error_parts`, one a slab (one for a
    whole grid)."""
    out = [(f"rel_err.{f}", rel_err_of_parts(parts[f]),
            float(limits["rel_err"])) for f in writes]
    out.append(("calls_off", calls_off, 0))
    return out


def passed(rows) -> bool:
    return all(v <= lim for _, v, lim in rows)
