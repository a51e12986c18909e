"""Fuse-group stencil kernel for Hopper, generated from the IR as CUDA C++.

Replaces the TPU kernel ``repro.kernels.stencil3d.build_group_call`` (the
Pallas call at ``src/repro/kernels/stencil3d.py:202``): one fuse group of a
stencil program over halo-padded input windows, in-group producers
recomputed on their margins (``passes.infer_halo``), zero-boundary temps
masked against the *global* domain through the runtime origin, scalars and
the origin as kernel arguments, 1-D coefficients read along their axis.

Bound on the H100: bytes.  The group reads each input once and writes each
output once (pw_advection: 3 + 3 float32 fields plus four 1-D
coefficients, about 24 B a point, 0.24 ms at 3.35 TB/s for 512x256x256);
its arithmetic is far below the card's float32 rate even with the margin
recompute.  The design keeps that traffic near the minimum:

* one CTA per output tile; its threads stage every group input's window
  (tile + input halo) in shared memory with coalesced loads along the
  contiguous axis 2, then each thread evaluates its points reading only
  shared memory — the halo re-reads of neighbouring tiles come from L2;
* in-group temps never touch memory: each thread evaluates a temp at every
  offset at which it is (transitively) read, as SSA registers with value
  numbering, so shared subtrees — the reference's hash-consed CSE — and
  repeated loads evaluate once.  This trades recompute (tracer_advection's
  deep chains) for zero synchronisation beyond the one after staging;
* the planner (``schedule.auto_plan``) picks a tile whose staged windows
  fit the 227 KB a CTA can use and that keeps the most threads resident
  per SM, then stages the fewest window bytes per point.

Windows inside an oversized fused-loop carry (``input_pad``) are read
through a base offset and the carry's strides; nothing is copied.  The C
entry returns ``cudaGetLastError()`` and the wrapper raises if it is not 0.
float32 and bfloat16 are compiled (bfloat16 rounds each op's result, as
the reference does); float64 raises ``NotImplementedError`` on the card.

:func:`group_call_reference` is the plain PyTorch version with the same
signature and geometry.  :class:`GroupCall` runs it for CPU tensors and
launches the kernel for CUDA tensors; ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from ..core.expr_eval import evaluate
from ..core.ir import (Access, BinOp, BinOpKind, Cmp, CmpKind, CoeffRef,
                       Const, ScalarRef, Select, UnOp, UnOpKind, Program)
from ..core.passes import GroupHalo, infer_halo
from ..core.schedule import cta_threads
from . import build

#: kernel launches made by :class:`GroupCall` (plain-version runs excluded)
launches = 0

#: the TPU kernel this module replaces
REPLACES = "src/repro/kernels/stencil3d.py:202"

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float64: "float64"}
_CTYPE = {"float32": "float", "bfloat16": "__nv_bfloat16"}

PREAMBLE = r"""// generated by repro_torch.kernels.stencil3d — do not edit
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float rmin(float a, float b) {
  return (a != a || b != b) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float rmax(float a, float b) {
  return (a != a || b != b) ? qnan() : fmaxf(a, b);
}
__device__ __forceinline__ float rsign(float a) {
  return (a != a) ? a : (float)((a > 0.0f) - (a < 0.0f));
}
__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
"""

_BIN_C = {
    BinOpKind.ADD: "({} + {})",
    BinOpKind.SUB: "({} - {})",
    BinOpKind.MUL: "({} * {})",
    BinOpKind.DIV: "({} / {})",
    BinOpKind.POW: "powf({}, {})",
    BinOpKind.MIN: "rmin({}, {})",
    BinOpKind.MAX: "rmax({}, {})",
}
_UN_C = {
    UnOpKind.NEG: "(-{})",
    UnOpKind.ABS: "fabsf({})",
    UnOpKind.SQRT: "sqrtf({})",
    UnOpKind.EXP: "expf({})",
    UnOpKind.LOG: "logf({})",
    UnOpKind.TANH: "tanhf({})",
    UnOpKind.SQUARE: "({0} * {0})",
    UnOpKind.SIGN: "rsign({})",
}
_CMP_C = {
    CmpKind.LT: "({} < {})",
    CmpKind.LE: "({} <= {})",
    CmpKind.GT: "({} > {})",
    CmpKind.GE: "({} >= {})",
    CmpKind.EQ: "({} == {})",
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def float_literal(v: float) -> str:
    """A float32 C++ literal of ``v`` (always ``f``-suffixed)."""
    x = float(np.float32(v))
    if math.isnan(x):
        return "qnan()"
    if math.isinf(x):
        return ("__int_as_float(0x7f800000)" if x > 0
                else "(-__int_as_float(0x7f800000))")
    s = str(np.float32(x))          # shortest text that round-trips
    if "." not in s and "e" not in s:
        s += ".0"
    s += "f"
    return f"({s})" if s.startswith("-") else s


class GroupCall:
    """One fuse group's kernel: callable(padded_inputs, scalars_vec,
    padded_coeffs, origin, input_pad) -> {output field: tensor}.

    ``padded_inputs`` must be padded by ``pad_lo``/``pad_hi``; with
    ``input_pad[f]`` an input may be an oversized buffer carrying that
    (ndim, 2) padding, from which the group reads its window in place.
    ``origin`` is the shard's global offset per axis (zeros by default) and
    ``global_extent`` the global domain — together they define the
    out-of-domain mask for margin-extended recompute.
    """

    def __init__(self, p: Program, group: Sequence[int],
                 block: Sequence[int], grid_shape: Sequence[int],
                 dtype=torch.float32,
                 global_extent: Sequence[int] | None = None):
        ndim = p.ndim
        gh: GroupHalo = infer_halo(p, group)
        self.program = p
        self.group = list(group)
        self.dtype = dtype
        self.ndim = ndim
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.block = tuple(min(int(b), int(g))
                           for b, g in zip(block[:ndim], self.grid_shape))
        self.global_extent = tuple(int(g) for g in (
            self.grid_shape if global_extent is None else global_extent))
        self.tiles = tuple(_cdiv(self.grid_shape[a], self.block[a])
                           for a in range(ndim))
        self.padded_out = tuple(self.tiles[a] * self.block[a]
                                for a in range(ndim))
        self.halo_lo = tuple(int(gh.input_halo[a, 0]) for a in range(ndim))
        self.halo_hi = tuple(int(gh.input_halo[a, 1]) for a in range(ndim))
        self.align_hi = tuple(self.padded_out[a] - self.grid_shape[a]
                              for a in range(ndim))
        self.pad_lo = self.halo_lo
        self.pad_hi = tuple(self.halo_hi[a] + self.align_hi[a]
                            for a in range(ndim))
        self.window = tuple(self.block[a] + self.halo_lo[a] + self.halo_hi[a]
                            for a in range(ndim))
        self.expect = tuple(self.halo_lo[a] + self.padded_out[a]
                            + self.halo_hi[a] for a in range(ndim))
        self.group_inputs = list(gh.group_inputs)
        self.group_coeffs = list(gh.group_coeffs)
        self.coeff_axis = {c: p.coeffs[c] for c in gh.group_coeffs}
        ops = [p.ops[i] for i in self.group]
        self.group_outputs = [op.out for op in ops
                              if op.out in set(gh.group_outputs)]
        self.margins = {p.ops[i].out: gh.margins[i] for i in self.group}
        # a periodic op's recomputed margins are exact (wraparound windows);
        # a zero-boundary op's out-of-domain values must read as 0
        self.masked = {op.out: bool(self.margins[op.out].any()
                                    and p.fields[op.out].boundary != "periodic")
                       for op in ops}
        self.n_scalars = len(p.scalars)
        self.dtype_name = _DTYPE_NAMES[dtype]
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        # shared memory of one CTA: every input's window in the field dtype
        self.smem_bytes = (int(np.prod(self.window)) * len(self.group_inputs)
                           * self.itemsize)
        # 3-D view of the geometry (1-D and 2-D programs get unit outer axes)
        lift = 3 - ndim
        self._lift = lift
        self.block3 = (1,) * lift + self.block
        self.window3 = (1,) * lift + self.window
        self.halo3 = (0,) * lift + self.halo_lo
        self.threads = cta_threads(self.block3)
        self.module = None
        self.entry = "g0"

    # ------------------------------------------------------------ running
    def __call__(self, padded_inputs: dict, scalars_vec=None,
                 padded_coeffs: dict | None = None, origin=None,
                 input_pad: dict | None = None) -> dict:
        ref = next((padded_inputs[f] for f in self.group_inputs),
                   None)
        if ref is None:
            ref = next(iter((padded_coeffs or {}).values()), None)
        if ref is None:
            raise ValueError("fuse group reads no field or coefficient")
        if ref.device.type == "cpu":
            return group_call_reference(self, padded_inputs, scalars_vec,
                                        padded_coeffs, origin, input_pad)
        if ref.device.type != "cuda":
            raise ValueError(f"no kernel for device {ref.device}")
        return self._launch(padded_inputs, scalars_vec, padded_coeffs or {},
                            origin, input_pad or {})

    def _launch(self, padded_inputs, scalars_vec, padded_coeffs, origin,
                input_pad) -> dict:
        global launches
        if self.dtype_name not in _CTYPE:
            raise NotImplementedError(
                f"the CUDA group kernel takes float32 or bfloat16, not "
                f"{self.dtype_name}")
        if self.module is None:
            bind([self])
        fn = self.module.function(self.entry)
        device = padded_inputs[self.group_inputs[0]].device \
            if self.group_inputs else padded_coeffs[self.group_coeffs[0]].device
        outs = {f: torch.empty(self.grid_shape, dtype=self.dtype,
                               device=device) for f in self.group_outputs}
        args = self.kernel_args(padded_inputs, scalars_vec, padded_coeffs,
                                origin, input_pad, outs)
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA group kernel {self.entry} of "
                               f"{self.program.name!r} failed to launch: "
                               f"cudaError {rc}")
        launches += 1
        return outs

    def kernel_args(self, padded_inputs, scalars_vec, padded_coeffs, origin,
                    input_pad, outs) -> list:
        """The kernel's arguments in :meth:`c_argtypes` order (without the
        stream), after checking every tensor's device, dtype, extent and
        layout: a window pointer at its base offset inside each input,
        with the input's strides; coefficient and output pointers; scalars;
        the origin.  1-D and 2-D programs get unit outer axes."""
        ndim, lift = self.ndim, self._lift
        device = next(iter(outs.values())).device
        args = []
        for f in self.group_inputs:
            x = padded_inputs[f]
            self._check(x, f, device)
            ip = (input_pad or {}).get(f)
            lo = [int(ip[a][0]) - self.halo_lo[a] if ip is not None else 0
                  for a in range(ndim)]
            for a in range(ndim):
                if lo[a] < 0 or x.shape[a] < lo[a] + self.expect[a]:
                    raise ValueError(
                        f"input {f!r} of shape {tuple(x.shape)} does not "
                        f"hold the window extent {self.expect} at offset "
                        f"{tuple(lo)}")
            if x.stride(-1) != 1:
                raise ValueError(f"input {f!r} must be contiguous along "
                                 "its last axis")
            base = sum(lo[a] * x.stride(a) for a in range(ndim))
            strides = [0] * lift + [x.stride(a) for a in range(ndim)]
            args += [x.data_ptr() + base * self.itemsize,
                     strides[0], strides[1]]
        for c in self.group_coeffs:
            t = padded_coeffs[c]
            self._check(t, c, device)
            need = self.expect[self.coeff_axis[c]]
            if t.ndim != 1 or not t.is_contiguous() or t.shape[0] < need:
                raise ValueError(f"coefficient {c!r} must be a contiguous "
                                 f"1-D tensor of at least {need} values")
            args.append(t.data_ptr())
        for f in self.group_outputs:
            o = outs[f]
            self._check(o, f, device)
            if tuple(o.shape) != self.grid_shape or not o.is_contiguous():
                raise ValueError(f"output {f!r} must be a contiguous "
                                 f"{self.grid_shape} tensor")
            args.append(o.data_ptr())
        svec = list(scalars_vec or [])
        if len(svec) < self.n_scalars:
            raise ValueError(f"expected {self.n_scalars} scalars, got "
                             f"{len(svec)}")
        args += [float(s) for s in svec[:self.n_scalars]]
        org = [0] * ndim if origin is None else [int(o) for o in origin]
        return args + [0] * lift + org

    def _check(self, t, name, device):
        if t.device != device:
            raise ValueError(f"{name!r} is on {t.device}, expected {device}")
        if t.dtype != self.dtype:
            raise ValueError(f"{name!r} has dtype {t.dtype}, expected "
                             f"{self.dtype}")

    # ----------------------------------------------------------- emitting
    def c_argtypes(self) -> list:
        n_in, n_c = len(self.group_inputs), len(self.group_coeffs)
        return ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * n_in
                + [ctypes.c_void_p] * n_c
                + [ctypes.c_void_p] * len(self.group_outputs)
                + [ctypes.c_float] * self.n_scalars
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def kernel_params(self) -> list:
        return kernel_params(self)

    def source(self, name: str | None = None) -> str:
        """CUDA C++ of this group's kernel and its C launch entry."""
        return _emit(self, name or self.entry)

    def flops_per_point(self) -> int:
        """Arithmetic ops the generated code performs per output point,
        margin recompute included."""
        return _Emitter(self).run()[1]


def build_group_call(p: Program, group: Sequence[int], block: Sequence[int],
                     grid_shape: Sequence[int], dtype=torch.float32,
                     global_extent: Sequence[int] | None = None) -> GroupCall:
    """The fuse group's kernel call (see :class:`GroupCall`)."""
    return GroupCall(p, group, block, grid_shape, dtype=dtype,
                     global_extent=global_extent)


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def group_call_reference(call: GroupCall, padded_inputs: dict,
                         scalars_vec=None, padded_coeffs: dict | None = None,
                         origin=None, input_pad: dict | None = None) -> dict:
    """The group's function in plain PyTorch, on any device: the
    reference's per-tile evaluation with the whole padded output as one
    tile (overlapped tiling is exact, so the tile does not change a value).
    Same arguments and geometry as the kernel, and the same rounding: a
    bfloat16 group computes each op in float32 and rounds its result."""
    p, ndim, dtype = call.program, call.ndim, call.dtype
    cdt = torch.float32 if dtype == torch.bfloat16 else dtype
    padded_coeffs = padded_coeffs or {}
    block = call.padded_out
    hl = call.halo_lo
    windows = {}
    device = None
    for f in call.group_inputs:
        x = padded_inputs[f]
        device = device or x.device
        ip = (input_pad or {}).get(f)
        lo = [int(ip[a][0]) - hl[a] if ip is not None else 0
              for a in range(ndim)]
        windows[f] = x[tuple(slice(lo[a], lo[a] + call.expect[a])
                             for a in range(ndim))].to(cdt)
    for c in call.group_coeffs:
        device = device or padded_coeffs[c].device
    svec = list(scalars_vec or [])
    scal = {s: torch.tensor(float(svec[i]), dtype=torch.float32,
                            device=device)
            for i, s in enumerate(p.scalars[:len(svec)])}
    org = [0] * ndim if origin is None else [int(o) for o in origin]
    produced = set(call.margins)
    results: dict = {}
    memo: dict = {}
    outs = {}
    for i in call.group:
        op = p.ops[i]
        m = call.margins[op.out]
        ext = tuple(block[ax] + int(m[ax, 0]) + int(m[ax, 1])
                    for ax in range(ndim))

        def coeff(c: CoeffRef, m=m, ext=ext):
            ax = call.coeff_axis[c.coeff]
            start = hl[ax] - int(m[ax, 0]) + c.offset
            v = padded_coeffs[c.coeff][start:start + ext[ax]].to(cdt)
            shape = [1] * ndim
            shape[ax] = ext[ax]
            return v.reshape(shape)

        def access(a: Access, m=m, ext=ext):
            if a.field in produced:
                src, base = results[a.field], call.margins[a.field][:, 0]
            else:
                src, base = windows[a.field], hl
            return src[tuple(
                slice(int(base[ax]) - int(m[ax, 0]) + a.offset[ax],
                      int(base[ax]) - int(m[ax, 0]) + a.offset[ax] + ext[ax])
                for ax in range(ndim))]

        mkey = tuple(int(v) for v in m.flatten())
        res = evaluate(op.expr, access, scal.__getitem__,
                       memo.setdefault(mkey, {}), coeff=coeff)
        if not isinstance(res, torch.Tensor):
            res = torch.tensor(res, device=device)
        res = res.to(dtype).expand(ext)
        if call.masked[op.out]:
            mask = torch.ones((), dtype=torch.bool, device=device)
            for ax in range(ndim):
                coord = (org[ax] - int(m[ax, 0])
                         + torch.arange(ext[ax], device=device))
                ok = (coord >= 0) & (coord < call.global_extent[ax])
                shape = [1] * ndim
                shape[ax] = ext[ax]
                mask = mask & ok.reshape(shape)
            res = torch.where(mask, res, torch.zeros((), dtype=dtype,
                                                     device=device))
        results[op.out] = res
        if op.out in call.group_outputs:
            outs[op.out] = res[tuple(
                slice(int(m[ax, 0]), int(m[ax, 0]) + call.grid_shape[ax])
                for ax in range(ndim))]
    return outs


# --------------------------------------------------------------------------
# The emitter: IR -> CUDA C++
# --------------------------------------------------------------------------

class _Emitter:
    """Per-thread SSA code for one output point of a fuse group.

    Every value is numbered by its structure: a load by (input, absolute
    offset), a temp by (field, offset), an operation by its kind and its
    operands' numbers — so a subtree shared between ops or between the
    offsets at which a temp is recomputed is emitted once.
    """

    def __init__(self, call: GroupCall):
        self.call = call
        p = call.program
        self.p = p
        self.lift = call._lift
        self.ops = {p.ops[i].out: p.ops[i] for i in call.group}
        self.inputs = {f: k for k, f in enumerate(call.group_inputs)}
        self.coeffs = {c: k for k, c in enumerate(call.group_coeffs)}
        self.scalars = {s: k for k, s in enumerate(p.scalars)}
        self.extent3 = (1,) * self.lift + call.global_extent
        self.lines: list = []
        self.vn: dict = {}
        self.flops = 0
        self.bf16 = call.dtype_name == "bfloat16"

    def _var(self, key, code, ty):
        hit = self.vn.get(key)
        if hit is not None:
            return hit
        name = f"v{len(self.vn)}"
        ctype = "bool" if ty == "b" else "float"
        self.lines.append(f"      const {ctype} {name} = {code};")
        self.vn[key] = (name, ty)
        return self.vn[key]

    @staticmethod
    def _f(x):
        code, ty = x
        return code if ty == "f" else f"({code} ? 1.0f : 0.0f)"

    @staticmethod
    def _b(x):
        code, ty = x
        return code if ty == "b" else f"({code} != 0.0f)"

    def ev(self, e, off: tuple):
        if isinstance(e, Const):
            return (float_literal(e.value), "f")
        if isinstance(e, ScalarRef):
            return (f"s{self.scalars[e.name]}", "f")
        if isinstance(e, CoeffRef):
            return self.coeff(e, off)
        if isinstance(e, Access):
            return self.access(e, off)
        if isinstance(e, BinOp):
            a, b = self.ev(e.lhs, off), self.ev(e.rhs, off)
            key = ("bin", e.kind, a, b)
            if key not in self.vn:
                self.flops += 1
            return self._var(key, _BIN_C[e.kind].format(self._f(a),
                                                         self._f(b)), "f")
        if isinstance(e, UnOp):
            a = self.ev(e.operand, off)
            key = ("un", e.kind, a)
            if key not in self.vn:
                self.flops += 1
            return self._var(key, _UN_C[e.kind].format(self._f(a)), "f")
        if isinstance(e, Cmp):
            a, b = self.ev(e.lhs, off), self.ev(e.rhs, off)
            key = ("cmp", e.kind, a, b)
            if key not in self.vn:
                self.flops += 1
            return self._var(key, _CMP_C[e.kind].format(self._f(a),
                                                         self._f(b)), "b")
        if isinstance(e, Select):
            c = self.ev(e.pred, off)
            t, f = self.ev(e.on_true, off), self.ev(e.on_false, off)
            key = ("sel", c, t, f)
            if key not in self.vn:
                self.flops += 1
            return self._var(key, f"({self._b(c)} ? {self._f(t)} : "
                                  f"{self._f(f)})", "f")
        raise TypeError(type(e))

    def coeff(self, e: CoeffRef, off: tuple):
        ax = self.call.coeff_axis[e.coeff] + self.lift
        o = off[ax] + int(e.offset)
        k = self.coeffs[e.coeff]
        return self._var(("coeff", k, o),
                         f"ld(&cf{k}[g{ax} + {self.call.halo3[ax] + o}])", "f")

    def access(self, e: Access, off: tuple):
        o = tuple(off[a] + v for a, v in
                  enumerate((0,) * self.lift + tuple(int(x) for x in
                                                     e.offset)))
        if e.field in self.ops:
            return self.temp(e.field, o)
        k = self.inputs[e.field]
        w = self.call.window3
        lin = (o[0] * w[1] + o[1]) * w[2] + o[2]
        return self._var(("in", k, o), f"ld(&win{k}[l + ({lin})])", "f")

    def temp(self, field: str, off: tuple):
        """The value of the group's op producing ``field`` at ``off``."""
        key = ("tmp", field, off)
        hit = self.vn.get(key)
        if hit is not None:
            return hit
        r = self.ev(self.ops[field].expr, off)
        code = self._f(r)
        if self.bf16:
            code = f"rnd_bf16({code})"
        if self.call.masked[field] and any(off):
            cond = " && ".join(
                f"G{a} + ({o}) >= 0 && G{a} + ({o}) < {self.extent3[a]}"
                for a, o in enumerate(off) if o)
            code = f"(({cond}) ? {code} : 0.0f)"
        if code == r[0] and r[1] == "f":
            self.vn[key] = r
            return r
        return self._var(key, code, "f")

    def run(self):
        outs = [(k, self.temp(f, (0, 0, 0)))
                for k, f in enumerate(self.call.group_outputs)]
        return outs, self.flops


def kernel_params(call: GroupCall) -> list:
    """The kernel's parameter declarations, in :meth:`GroupCall.c_argtypes`
    order (without the launch entry's trailing stream)."""
    T = _CTYPE[call.dtype_name]
    params = []
    for k in range(len(call.group_inputs)):
        params += [f"const {T}* __restrict__ in{k}", f"long long in{k}_s0",
                   f"long long in{k}_s1"]
    params += [f"const {T}* __restrict__ cf{k}"
               for k in range(len(call.group_coeffs))]
    params += [f"{T}* __restrict__ out{k}"
               for k in range(len(call.group_outputs))]
    params += [f"float s{k}" for k in range(call.n_scalars)]
    params += ["int org0", "int org1", "int org2"]
    return params


def _emit(call: GroupCall, name: str) -> str:
    if call.dtype_name not in _CTYPE:
        raise NotImplementedError(
            f"the CUDA group kernel takes float32 or bfloat16, not "
            f"{call.dtype_name}")
    T = _CTYPE[call.dtype_name]
    em = _Emitter(call)
    outs, _ = em.run()
    B, W, H = call.block3, call.window3, call.halo3
    N = (1,) * call._lift + call.grid_shape
    tiles = (1,) * call._lift + call.tiles
    tx, ty = call.threads
    n_in = len(call.group_inputs)
    win = int(np.prod(W))

    params = kernel_params(call)
    args = [q.split()[-1] for q in params]

    fields = ", ".join(call.group_inputs)
    body = [f"// fuse group {call.group} of {call.program.name}: "
            f"inputs [{fields}], outputs [{', '.join(call.group_outputs)}]",
            f"// tile {B}, window {W}, {call.smem_bytes} B shared memory",
            f"__global__ void __launch_bounds__({tx * ty})",
            f"{name}_kernel({', '.join(params)}) {{"]
    body.append("  extern __shared__ __align__(16) unsigned char smem_raw[];")
    for k in range(n_in):
        body.append(f"  {T}* win{k} = reinterpret_cast<{T}*>(smem_raw)"
                    f" + {k * win};")
    body += [
        "  const int bid = blockIdx.x;",
        f"  const int t2 = (bid % {tiles[2]}) * {B[2]};",
        f"  const int t1 = ((bid / {tiles[2]}) % {tiles[1]}) * {B[1]};",
        f"  const int t0 = (bid / {tiles[2] * tiles[1]}) * {B[0]};",
        "  // stage every input's window (tile + halo), coalesced on axis 2",
        f"  for (int row = threadIdx.y; row < {W[0] * W[1]}; row += {ty}) {{",
        f"    const int w0 = row / {W[1]}, w1 = row % {W[1]};",
        f"    for (int w2 = threadIdx.x; w2 < {W[2]}; w2 += {tx}) {{",
        f"      const int l = row * {W[2]} + w2;",
    ]
    for k in range(n_in):
        body.append(f"      win{k}[l] = in{k}[(long long)(t0 + w0) * in{k}_s0"
                    f" + (long long)(t1 + w1) * in{k}_s1 + (t2 + w2)];")
    body += [
        "    }",
        "  }",
        "  __syncthreads();",
        f"  for (int i0 = 0; i0 < {B[0]}; ++i0) {{",
        "    const int g0 = t0 + i0;",
        f"    if (g0 >= {N[0]}) break;",
        f"    for (int i1 = threadIdx.y; i1 < {B[1]}; i1 += {ty}) {{",
        "      const int g1 = t1 + i1;",
        f"      if (g1 >= {N[1]}) break;",
        f"      for (int i2 = threadIdx.x; i2 < {B[2]}; i2 += {tx}) {{",
        "      const int g2 = t2 + i2;",
        f"      if (g2 >= {N[2]}) break;",
        f"      const int l = ((i0 + {H[0]}) * {W[1]} + (i1 + {H[1]})) * {W[2]}"
        f" + (i2 + {H[2]});",
        "      const int G0 = org0 + g0, G1 = org1 + g1, G2 = org2 + g2;",
        "      (void)l; (void)G0; (void)G1; (void)G2;",
    ]
    body += em.lines
    body.append(f"      const long long o = ((long long)g0 * {N[1]} + g1)"
                f" * {N[2]} + g2;")
    for k, (code, ty_) in outs:
        body.append(f"      st(&out{k}[o], {em._f((code, ty_))});")
    body += ["      }", "    }", "  }", "}", ""]

    n_tiles = int(np.prod(tiles))
    body += [
        f'extern "C" int {name}_launch({", ".join(params)}, void* stream) {{',
        "  static bool ready = false;",
        f"  if (!ready && {call.smem_bytes} > 48 * 1024) {{",
        f"    cudaError_t e = cudaFuncSetAttribute({name}_kernel,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize,"
        f" {call.smem_bytes});",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        "  ready = true;",
        f"  {name}_kernel<<<{n_tiles}, dim3({tx}, {ty}), {call.smem_bytes},"
        f" (cudaStream_t)stream>>>({', '.join(args)});",
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ]
    return "\n".join(body)


# --------------------------------------------------------------------------
# One translation unit per compiled program
# --------------------------------------------------------------------------

class KernelModule:
    """The kernels of one compiled program in one translation unit, built
    by one ``nvcc`` call on first launch."""

    def __init__(self, calls: Sequence[GroupCall]):
        self.calls = list(calls)
        self.source = PREAMBLE + "\n".join(
            c.source(f"g{i}") for i, c in enumerate(self.calls))
        self._lib = None
        self._fns: dict = {}

    def library(self):
        if self._lib is None:
            self._lib = build.load(self.source)
        return self._lib

    def function(self, entry: str):
        fn = self._fns.get(entry)
        if fn is None:
            k = int(entry[1:])
            fn = getattr(self.library(), f"{entry}_launch")
            fn.argtypes = self.calls[k].c_argtypes()
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return fn


def bind(calls: Sequence[GroupCall]) -> KernelModule | None:
    """Put ``calls`` into one :class:`KernelModule` (float32/bfloat16
    calls only; float64 calls stay unbound and raise when launched)."""
    calls = list(calls)
    if any(c.dtype_name not in _CTYPE for c in calls):
        return None
    mod = KernelModule(calls)
    for i, c in enumerate(calls):
        c.module, c.entry = mod, f"g{i}"
    return mod
