"""Frontend: builds stencil IR from plain Python — the PSyclone/Devito role.

The paper's DSLs lower Fortran/Python into the MLIR stencil dialect; here a
:class:`ProgramBuilder` plays that part.  Field handles support ``f[di,dj,dk]``
relative accesses and normal arithmetic, so a kernel is written essentially as
the maths appears in the source paper:

    b = ProgramBuilder("pw_advection", ndim=3)
    u, v, w = b.inputs("u", "v", "w")
    tzc1, tzc2 = b.scalars("tzc1", "tzc2")
    su = b.output("su")
    b.define(su, tzc1 * u[-1, 0, 0] * (w[-1, 0, 0] + w[0, 0, 0]) - ...)
    prog = b.build()
"""

from __future__ import annotations

import numbers

from .ir import (Access, BinOp, BinOpKind, Cmp, CmpKind, CoeffRef, Const,
                 Expr, FieldDecl, FieldRole, Program, ScalarRef, Select,
                 StencilOp, UnOp, UnOpKind)

__all__ = [
    "ProgramBuilder", "ExprHandle", "FieldHandle", "CoeffHandle",
    "minimum", "maximum", "sqrt", "exp", "log", "tanh", "absolute", "where",
    "sign",
]


def _wrap(x) -> Expr:
    if isinstance(x, ExprHandle):
        return x.expr
    if isinstance(x, numbers.Real):
        return Const(float(x))
    if isinstance(x, Expr):
        return x
    raise TypeError(f"cannot use {type(x)} in a stencil expression")


class ExprHandle:
    """Wraps an ir.Expr and overloads Python arithmetic."""

    __slots__ = ("expr",)
    __array_priority__ = 1000  # win against numpy scalars

    def __init__(self, expr: Expr):
        self.expr = expr

    def __bool__(self):
        # a traced value has no truth value: branching on it would bake one
        # arm into the expression
        raise TypeError("a stencil expression has no truth value; use "
                        "where(...) instead of a Python branch")

    # -- arithmetic ----------------------------------------------------
    def _bin(self, other, kind, swap=False):
        a, b = _wrap(self), _wrap(other)
        if swap:
            a, b = b, a
        return ExprHandle(BinOp(kind, a, b))

    def __add__(self, o):  return self._bin(o, BinOpKind.ADD)
    def __radd__(self, o): return self._bin(o, BinOpKind.ADD, swap=True)
    def __sub__(self, o):  return self._bin(o, BinOpKind.SUB)
    def __rsub__(self, o): return self._bin(o, BinOpKind.SUB, swap=True)
    def __mul__(self, o):  return self._bin(o, BinOpKind.MUL)
    def __rmul__(self, o): return self._bin(o, BinOpKind.MUL, swap=True)
    def __truediv__(self, o):  return self._bin(o, BinOpKind.DIV)
    def __rtruediv__(self, o): return self._bin(o, BinOpKind.DIV, swap=True)
    def __pow__(self, o):  return self._bin(o, BinOpKind.POW)
    def __neg__(self):     return ExprHandle(UnOp(UnOpKind.NEG, _wrap(self)))

    def __lt__(self, o): return ExprHandle(Cmp(CmpKind.LT, _wrap(self), _wrap(o)))
    def __le__(self, o): return ExprHandle(Cmp(CmpKind.LE, _wrap(self), _wrap(o)))
    def __gt__(self, o): return ExprHandle(Cmp(CmpKind.GT, _wrap(self), _wrap(o)))
    def __ge__(self, o): return ExprHandle(Cmp(CmpKind.GE, _wrap(self), _wrap(o)))


class FieldHandle:
    """A named grid field; ``f[offsets]`` yields an Access expression."""

    __slots__ = ("name", "ndim", "_builder")

    def __init__(self, name: str, ndim: int, builder: "ProgramBuilder"):
        self.name = name
        self.ndim = ndim
        self._builder = builder

    def __getitem__(self, offsets) -> ExprHandle:
        if self.ndim == 1 and isinstance(offsets, int):
            offsets = (offsets,)
        if not isinstance(offsets, tuple) or len(offsets) != self.ndim:
            raise ValueError(
                f"{self.name}[...] needs {self.ndim} integer offsets, got {offsets!r}")
        if not all(isinstance(o, int) for o in offsets):
            raise ValueError("stencil offsets must be compile-time integers")
        return ExprHandle(Access(self.name, tuple(offsets)))

    @property
    def c(self) -> ExprHandle:
        """Center access, f[0,...,0]."""
        return self[(0,) * self.ndim] if self.ndim > 1 else self[0]


class CoeffHandle:
    """1-D per-axis coefficient ('small data'); ``c[dk]`` reads at offset."""

    __slots__ = ("name", "axis")

    def __init__(self, name: str, axis: int):
        self.name = name
        self.axis = axis

    def __getitem__(self, off) -> ExprHandle:
        if not isinstance(off, int):
            raise ValueError("coefficient offsets must be compile-time ints")
        return ExprHandle(CoeffRef(self.name, off))

    @property
    def c(self) -> ExprHandle:
        return self[0]


# -- free functions mirroring arith/math dialect ops -----------------------

def minimum(a, b): return ExprHandle(BinOp(BinOpKind.MIN, _wrap(a), _wrap(b)))
def maximum(a, b): return ExprHandle(BinOp(BinOpKind.MAX, _wrap(a), _wrap(b)))
def sqrt(a):       return ExprHandle(UnOp(UnOpKind.SQRT, _wrap(a)))
def exp(a):        return ExprHandle(UnOp(UnOpKind.EXP, _wrap(a)))
def log(a):        return ExprHandle(UnOp(UnOpKind.LOG, _wrap(a)))
def tanh(a):       return ExprHandle(UnOp(UnOpKind.TANH, _wrap(a)))
def absolute(a):   return ExprHandle(UnOp(UnOpKind.ABS, _wrap(a)))
def sign(a):       return ExprHandle(UnOp(UnOpKind.SIGN, _wrap(a)))
def where(p, t, f):
    return ExprHandle(Select(_wrap(p), _wrap(t), _wrap(f)))


class ProgramBuilder:
    """Declares fields, scalars and coefficients and defines ops.

    ``boundary`` is every declared field's default: ``"zero"``,
    ``"periodic"``, or a sequence of those, one per axis (such as
    ``("periodic", "periodic", "zero")``, a domain that wraps along x and
    y and is bounded along z); ``input``/``output``/``temp`` take one to
    override it for a field.
    """

    def __init__(self, name: str, ndim: int, boundary="zero"):
        if ndim not in (1, 2, 3):
            raise ValueError("ndim must be 1..3")
        self.name = name
        self.ndim = ndim
        self.boundary = boundary      # default for every declared field
        self._fields: dict = {}
        self._scalars: list = []
        self._coeffs: dict = {}
        self._ops: list = []

    # -- declarations ---------------------------------------------------
    def input(self, name: str, boundary=None) -> FieldHandle:
        self._declare(name, FieldRole.INPUT, boundary)
        return FieldHandle(name, self.ndim, self)

    def inputs(self, *names: str):
        return tuple(self.input(n) for n in names)

    def output(self, name: str, boundary=None) -> FieldHandle:
        self._declare(name, FieldRole.OUTPUT, boundary)
        return FieldHandle(name, self.ndim, self)

    def outputs(self, *names: str):
        return tuple(self.output(n) for n in names)

    def temp(self, name: str, boundary=None) -> FieldHandle:
        """Field produced and consumed inside the program, never stored."""
        self._declare(name, FieldRole.TEMP, boundary)
        return FieldHandle(name, self.ndim, self)

    def scalar(self, name: str) -> ExprHandle:
        if name in self._scalars:
            raise ValueError(f"duplicate scalar {name!r}")
        self._scalars.append(name)
        return ExprHandle(ScalarRef(name))

    def scalars(self, *names: str):
        return tuple(self.scalar(n) for n in names)

    def coeff(self, name: str, axis: int) -> CoeffHandle:
        """Declare a 1-D coefficient array along ``axis`` ('small data')."""
        if name in self._coeffs:
            raise ValueError(f"duplicate coeff {name!r}")
        if not 0 <= axis < self.ndim:
            raise ValueError(f"axis {axis} out of range for {self.ndim}-D")
        self._coeffs[name] = axis
        return CoeffHandle(name, axis)

    def _declare(self, name: str, role: FieldRole, boundary=None):
        if name in self._fields:
            raise ValueError(f"duplicate field {name!r}")
        self._fields[name] = FieldDecl(
            name=name, role=role,
            boundary=self.boundary if boundary is None else boundary)

    # -- op definition ----------------------------------------------------
    def define(self, out: FieldHandle, expr, name: str = "") -> None:
        """stencil.apply: out = expr (one output field per op)."""
        if self._fields[out.name].role == FieldRole.INPUT:
            raise ValueError(f"cannot write input field {out.name!r}")
        if any(op.out == out.name for op in self._ops):
            raise ValueError(f"field {out.name!r} already defined")
        self._ops.append(StencilOp(out=out.name, expr=_wrap(expr),
                                   name=name or out.name))

    def build(self) -> Program:
        p = Program(name=self.name, ndim=self.ndim, fields=dict(self._fields),
                    scalars=list(self._scalars), ops=list(self._ops),
                    coeffs=dict(self._coeffs))
        p.validate()
        return p
