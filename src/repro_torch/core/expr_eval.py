"""Shared expression-tree evaluator over tensors (the port of
``repro.core.expr_eval``).

The pure-torch lowerings and the kernel's plain version evaluate the same
IR by supplying an *access resolver*; hash-consing of the frozen Expr nodes
gives CSE through the memo table.

Numerics follow the reference: ``SIGN(0) == 0`` (``torch.sign``), ``Select``
is ``torch.where``, and Python-float constants never widen a float32
computation to float64 — a constant meets a tensor as a weak scalar (the
tensor's dtype wins), and an operation between two constants is rounded
through float32 as JAX's weakly typed scalars are.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .ir import (Access, BinOp, BinOpKind, Cmp, CmpKind, CoeffRef, Const,
                 Expr, ScalarRef, Select, UnOp, UnOpKind)

_BIN = {
    BinOpKind.ADD: lambda a, b: a + b,
    BinOpKind.SUB: lambda a, b: a - b,
    BinOpKind.MUL: lambda a, b: a * b,
    BinOpKind.DIV: lambda a, b: a / b,
    BinOpKind.POW: lambda a, b: a ** b,
    BinOpKind.MIN: lambda a, b: torch.minimum(*_tensors(a, b)),
    BinOpKind.MAX: lambda a, b: torch.maximum(*_tensors(a, b)),
}
_UN = {
    UnOpKind.NEG: lambda a: -a,
    UnOpKind.ABS: torch.abs,
    UnOpKind.SQRT: torch.sqrt,
    UnOpKind.EXP: torch.exp,
    UnOpKind.LOG: torch.log,
    UnOpKind.TANH: torch.tanh,
    UnOpKind.SQUARE: torch.square,
    UnOpKind.SIGN: torch.sign,
}
_CMP = {
    CmpKind.LT: lambda a, b: a < b,
    CmpKind.LE: lambda a, b: a <= b,
    CmpKind.GT: lambda a, b: a > b,
    CmpKind.GE: lambda a, b: a >= b,
    CmpKind.EQ: lambda a, b: a == b,
}

# constant folding between two Python scalars, in float32 as JAX does
_NP_BIN = {
    BinOpKind.ADD: np.add, BinOpKind.SUB: np.subtract,
    BinOpKind.MUL: np.multiply, BinOpKind.DIV: np.divide,
    BinOpKind.POW: np.power, BinOpKind.MIN: np.minimum,
    BinOpKind.MAX: np.maximum,
}
_NP_UN = {
    UnOpKind.NEG: np.negative, UnOpKind.ABS: np.abs, UnOpKind.SQRT: np.sqrt,
    UnOpKind.EXP: np.exp, UnOpKind.LOG: np.log, UnOpKind.TANH: np.tanh,
    UnOpKind.SQUARE: np.square, UnOpKind.SIGN: np.sign,
}


def _tensors(a, b):
    """``torch.minimum``/``maximum`` take tensors only: lift a Python
    scalar operand to a 0-d tensor of the other operand's dtype."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a, b


def _f32(x) -> float:
    return float(np.float32(x))


def evaluate(expr: Expr, access: Callable[[Access], torch.Tensor],
             scalar: Callable[[str], torch.Tensor], memo: dict | None = None,
             coeff: Callable[[CoeffRef], torch.Tensor] | None = None):
    """Evaluate ``expr``; ``access`` resolves Access nodes, ``scalar`` names,
    ``coeff`` CoeffRef nodes (broadcastable 1-D coefficient reads).  The
    result is a tensor, or a Python float for a constant expression."""
    if memo is None:
        memo = {}

    def rec(e: Expr):
        hit = memo.get(e)
        if hit is not None:
            return hit
        if isinstance(e, Const):
            r = _f32(e.value)
        elif isinstance(e, ScalarRef):
            r = scalar(e.name)
        elif isinstance(e, CoeffRef):
            if coeff is None:
                raise ValueError("program uses coefficients but no resolver given")
            r = coeff(e)
        elif isinstance(e, Access):
            r = access(e)
        elif isinstance(e, BinOp):
            a, b = rec(e.lhs), rec(e.rhs)
            if isinstance(a, float) and isinstance(b, float):
                with np.errstate(all="ignore"):
                    r = _f32(_NP_BIN[e.kind](np.float32(a), np.float32(b)))
            else:
                r = _BIN[e.kind](a, b)
        elif isinstance(e, UnOp):
            a = rec(e.operand)
            if isinstance(a, float):
                with np.errstate(all="ignore"):
                    r = _f32(_NP_UN[e.kind](np.float32(a)))
            else:
                r = _UN[e.kind](a)
        elif isinstance(e, Cmp):
            r = _CMP[e.kind](rec(e.lhs), rec(e.rhs))
        elif isinstance(e, Select):
            pred, t, f = rec(e.pred), rec(e.on_true), rec(e.on_false)
            if not isinstance(pred, torch.Tensor):
                r = t if pred else f
            else:
                if pred.dtype != torch.bool:
                    pred = pred != 0
                r = torch.where(pred, t, f)
        else:
            raise TypeError(type(e))
        memo[e] = r
        return r

    try:
        return rec(expr)
    finally:
        # ``rec`` refers to itself through its closure: break that cycle,
        # or the memo's device tensors live on until the cyclic collector
        # runs (it counts Python objects, not device memory)
        rec = None

