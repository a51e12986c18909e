"""Stencil IR — the analogue of the MLIR ``stencil`` dialect (paper §2.2.1).

A :class:`Program` is a set of typed grid fields plus an ordered list of
:class:`StencilOp`, each producing one output field from an expression tree
over relative-offset :class:`Access` nodes — exactly the information content
of ``stencil.load / stencil.apply / stencil.access / stencil.return /
stencil.store``.  Everything downstream (the planner = HLS-dialect analogue,
the jnp and Pallas backends, the distributed executor) consumes this IR.

Semantics
---------
* All fields share one logical grid of rank ``ndim`` (1..3).
* ``Access(field, offset)`` reads the field at ``index + offset``;
  out-of-domain reads return 0 (zero-halo convention, applied identically by
  every backend, including the distributed one via ``lax.ppermute``'s
  zero-fill at torus edges).
* Ops may read fields produced by *earlier* ops in the same program — the
  dependency structure the paper calls out for tracer advection.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


class BinOpKind(str, enum.Enum):
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    POW = "pow"
    MIN = "min"
    MAX = "max"


class UnOpKind(str, enum.Enum):
    NEG = "neg"
    ABS = "abs"
    SQRT = "sqrt"
    EXP = "exp"
    LOG = "log"
    TANH = "tanh"
    SQUARE = "square"
    SIGN = "sign"


class CmpKind(str, enum.Enum):
    LT = "lt"
    LE = "le"
    GT = "gt"
    GE = "ge"
    EQ = "eq"


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base class: all nodes are frozen dataclasses, hashable for CSE."""

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True)
class ScalarRef(Expr):
    """A runtime scalar argument ('small data' the paper copies to BRAM)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Access(Expr):
    """stencil.access: read ``field`` at relative ``offset``."""

    field: str
    offset: tuple  # tuple[int, ...] of length ndim


@dataclasses.dataclass(frozen=True)
class CoeffRef(Expr):
    """Read a 1-D coefficient array along one grid axis at a relative offset.

    This is the paper's 'small data' (step 8): per-level coefficients such as
    MONC's tzc1(k)/tzc2(k), copied into local memory (BRAM on FPGA, VMEM/SMEM
    resident here) rather than streamed from external memory.
    """

    coeff: str
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    kind: BinOpKind
    lhs: Expr
    rhs: Expr

    def children(self):
        return (self.lhs, self.rhs)


@dataclasses.dataclass(frozen=True)
class UnOp(Expr):
    kind: UnOpKind
    operand: Expr

    def children(self):
        return (self.operand,)


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    kind: CmpKind
    lhs: Expr
    rhs: Expr

    def children(self):
        return (self.lhs, self.rhs)


@dataclasses.dataclass(frozen=True)
class Select(Expr):
    pred: Expr
    on_true: Expr
    on_false: Expr

    def children(self):
        return (self.pred, self.on_true, self.on_false)


# --------------------------------------------------------------------------
# Program structure
# --------------------------------------------------------------------------


class FieldRole(str, enum.Enum):
    INPUT = "input"          # stencil field input       (paper step 1)
    OUTPUT = "output"        # stencil field output
    TEMP = "temp"            # produced AND consumed internally


@dataclasses.dataclass
class FieldDecl:
    name: str
    role: FieldRole
    dtype: str = "float32"
    # how reads outside the domain resolve: "zero" (historical convention)
    # or "periodic" (torus wraparound) — see repro_torch.core.boundary
    boundary: str = "zero"


@dataclasses.dataclass
class StencilOp:
    """One ``stencil.apply`` producing a single output field.

    The paper's transformation *splits* multi-field applies into per-field
    ops (step 4); this IR is born already in that normal form — the frontend
    emits one op per assigned output.
    """

    out: str
    expr: Expr
    name: str = ""

    def accesses(self) -> list[Access]:
        out: list[Access] = []

        def rec(e: Expr):
            if isinstance(e, Access):
                out.append(e)
            for c in e.children():
                rec(c)

        rec(self.expr)
        return out

    def coeff_refs(self) -> list["CoeffRef"]:
        out: list[CoeffRef] = []

        def rec(e: Expr):
            if isinstance(e, CoeffRef):
                out.append(e)
            for c in e.children():
                rec(c)

        rec(self.expr)
        return out


@dataclasses.dataclass
class Program:
    name: str
    ndim: int
    fields: dict            # name -> FieldDecl
    scalars: list           # list[str] runtime scalar names, ordered
    ops: list               # list[StencilOp], in definition order
    coeffs: dict = dataclasses.field(default_factory=dict)  # name -> axis

    # ------------------------------------------------------------------
    # Derived structure
    # ------------------------------------------------------------------
    def validate(self) -> None:
        defined = {n for n, f in self.fields.items() if f.role == FieldRole.INPUT}
        produced: set = set()
        for op in self.ops:
            if op.out not in self.fields:
                raise ValueError(f"op writes undeclared field {op.out!r}")
            for a in op.accesses():
                if len(a.offset) != self.ndim:
                    raise ValueError(
                        f"offset {a.offset} has rank {len(a.offset)}, program is {self.ndim}-D")
                if a.field not in self.fields:
                    raise ValueError(f"access to undeclared field {a.field!r}")
                if a.field not in defined and a.field not in produced:
                    raise ValueError(
                        f"op {op.name or op.out!r} reads {a.field!r} before it is produced")
            for c in op.coeff_refs():
                if c.coeff not in self.coeffs:
                    raise ValueError(f"access to undeclared coeff {c.coeff!r}")
            produced.add(op.out)
        for n, f in self.fields.items():
            if f.role in (FieldRole.OUTPUT, FieldRole.TEMP) and n not in produced:
                raise ValueError(f"declared output {n!r} never produced")
        from .boundary import validate_boundaries
        validate_boundaries(self)

    def boundaries(self) -> dict:
        """field name -> boundary kind ("zero" | "periodic")."""
        return {n: f.boundary for n, f in self.fields.items()}

    def is_torus(self) -> bool:
        """True when every field is periodic (the whole domain wraps)."""
        return all(f.boundary == "periodic" for f in self.fields.values())

    def with_boundary(self, spec) -> "Program":
        """A copy of this program with boundaries replaced.

        ``spec`` is either a single kind applied to every field (the usual
        torus/zero toggle) or a mapping ``{field: kind}`` overriding only
        the named fields.  The copy is re-validated.
        """
        if isinstance(spec, str):
            spec = {n: spec for n in self.fields}
        unknown = set(spec) - set(self.fields)
        if unknown:
            raise ValueError(f"with_boundary: unknown field(s) "
                             f"{sorted(unknown)}; fields are "
                             f"{sorted(self.fields)}")
        fields = {n: dataclasses.replace(f, boundary=spec.get(n, f.boundary))
                  for n, f in self.fields.items()}
        p = Program(name=self.name, ndim=self.ndim, fields=fields,
                    scalars=list(self.scalars), ops=list(self.ops),
                    coeffs=dict(self.coeffs))
        p.validate()
        return p

    def input_fields(self) -> list:
        return [n for n, f in self.fields.items() if f.role == FieldRole.INPUT]

    def output_fields(self) -> list:
        return [n for n, f in self.fields.items() if f.role == FieldRole.OUTPUT]

    def temp_fields(self) -> list:
        return [n for n, f in self.fields.items() if f.role == FieldRole.TEMP]

    def op_producing(self, field: str):
        for i, op in enumerate(self.ops):
            if op.out == field:
                return i
        return None

    def flops_per_point(self) -> int:
        """Arithmetic ops per grid point (one pass over all ops)."""
        total = 0
        for op in self.ops:
            total += count_flops(op.expr)
        return total

    # ------------------------------------------------------------------
    # Pretty printing (stencil-dialect-like, for docs/debugging)
    # ------------------------------------------------------------------
    def to_text(self) -> str:
        lines = [f"stencil.program @{self.name} ndim={self.ndim} {{"]
        for s in self.scalars:
            lines.append(f"  %{s} = stencil.scalar_arg")
        for n, f in self.fields.items():
            if f.role == FieldRole.INPUT:
                lines.append(f"  %{n} = stencil.load : field<{f.dtype}>")
        for op in self.ops:
            lines.append(f"  %{op.out} = stencil.apply {{")
            lines.append(f"    {format_expr(op.expr)}")
            lines.append("  }")
        for n in self.output_fields():
            lines.append(f"  stencil.store %{n}")
        lines.append("}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Expression helpers
# --------------------------------------------------------------------------

_FLOP_COST = {
    BinOpKind.ADD: 1, BinOpKind.SUB: 1, BinOpKind.MUL: 1, BinOpKind.DIV: 1,
    BinOpKind.POW: 10, BinOpKind.MIN: 1, BinOpKind.MAX: 1,
}
_UNOP_COST = {
    UnOpKind.NEG: 1, UnOpKind.ABS: 1, UnOpKind.SQRT: 4, UnOpKind.EXP: 8,
    UnOpKind.LOG: 8, UnOpKind.TANH: 10, UnOpKind.SQUARE: 1, UnOpKind.SIGN: 1,
}


def count_flops(e: Expr) -> int:
    n = 0
    if isinstance(e, BinOp):
        n += _FLOP_COST[e.kind]
    elif isinstance(e, UnOp):
        n += _UNOP_COST[e.kind]
    elif isinstance(e, (Cmp, Select)):
        n += 1
    for c in e.children():
        n += count_flops(c)
    return n


def format_expr(e: Expr) -> str:
    if isinstance(e, Const):
        return repr(e.value)
    if isinstance(e, ScalarRef):
        return f"%{e.name}"
    if isinstance(e, Access):
        off = ",".join(str(o) for o in e.offset)
        return f"%{e.field}[{off}]"
    if isinstance(e, CoeffRef):
        return f"%{e.coeff}<{e.offset:+d}>"
    if isinstance(e, BinOp):
        return f"({format_expr(e.lhs)} {e.kind.value} {format_expr(e.rhs)})"
    if isinstance(e, UnOp):
        return f"{e.kind.value}({format_expr(e.operand)})"
    if isinstance(e, Cmp):
        return f"({format_expr(e.lhs)} {e.kind.value} {format_expr(e.rhs)})"
    if isinstance(e, Select):
        return (f"select({format_expr(e.pred)}, {format_expr(e.on_true)}, "
                f"{format_expr(e.on_false)})")
    raise TypeError(type(e))


def map_expr(e: Expr, fn: Callable[[Expr], Expr | None]) -> Expr:
    """Bottom-up rewrite: ``fn`` may return a replacement or None to keep."""
    if isinstance(e, BinOp):
        e = BinOp(e.kind, map_expr(e.lhs, fn), map_expr(e.rhs, fn))
    elif isinstance(e, UnOp):
        e = UnOp(e.kind, map_expr(e.operand, fn))
    elif isinstance(e, Cmp):
        e = Cmp(e.kind, map_expr(e.lhs, fn), map_expr(e.rhs, fn))
    elif isinstance(e, Select):
        e = Select(map_expr(e.pred, fn), map_expr(e.on_true, fn),
                   map_expr(e.on_false, fn))
    r = fn(e)
    return e if r is None else r


def expr_fields(e: Expr) -> set:
    return {a.field for a in _collect_accesses(e)}


def _collect_accesses(e: Expr) -> list:
    out = []

    def rec(x):
        if isinstance(x, Access):
            out.append(x)
        for c in x.children():
            rec(c)

    rec(e)
    return out
