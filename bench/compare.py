"""The comparison that decides ``correct``.

A call's fields after its steps are held against the reference's: for
each field the update changes, the largest absolute difference over the
reference's largest absolute value. Each call of the window is also held
to the compared call bit for bit, through a digest of its changed fields
(every call starts from the same inputs). Each number has its limit from
the cell's file under ``bench/limits/``.
"""

from __future__ import annotations

import math


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    if scale > 0:
        return err / scale
    return 0.0 if err == 0 else math.inf


def digest(torch, fields: dict, names) -> "torch.Tensor":
    """Per field, the sum of its elements' bit patterns as 64-bit
    integers: any changed bit changes it."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.stack([fields[f].view(bits[fields[f].element_size()])
                        .sum(dtype=torch.int64) for f in names])


def checks(got: dict, want: dict, writes, limits: dict,
           calls_off: int) -> list:
    """``[(name, value, limit)]`` of every number compared."""
    out = [(f"rel_err.{f}", rel_err(got[f], want[f]),
            float(limits["rel_err"])) for f in writes]
    out.append(("calls_off", calls_off, 0))
    return out


def passed(rows) -> bool:
    return all(v <= lim for _, v, lim in rows)
