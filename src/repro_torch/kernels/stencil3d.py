"""Fuse-group stencil kernel for Hopper, generated from the IR as CUDA C++.

Replaces the TPU kernel ``repro.kernels.stencil3d.build_group_call`` (the
Pallas call at ``src/repro/kernels/stencil3d.py:202``): one fuse group of a
stencil program over halo-padded inputs, every op evaluated over its
margins (``passes.infer_halo``), zero-boundary temps masked against the
*global* domain through the runtime origin, scalars and the origin as
kernel arguments, 1-D coefficients read along their axis.

Bound on the H100: bytes.  The group reads each input once and writes each
output once (pw_advection: 3 + 3 float32 fields, about 24 B a point,
0.24 ms at 3.35 TB/s for 512x256x256; tracer_advection: 6 + 1 fields, 28 B
a point); its IR operations are far below the card's float32 rate.  The
TPU kernel evaluates each op once over its margin-extended block; a CUDA
CTA cannot hold a 3-D block of every op in 227 KB, so the design sweeps
(2.5-D, :func:`repro_torch.core.schedule.plan_block_cta`):

* one CTA per (chunk of axis 0, tile of axes 1 and 2); it sweeps its chunk
  plane by plane, starting ``warmup`` planes early;
* every group input has a ring of planes (its halo around the tile) in
  shared memory; the plane the next iteration needs is fetched with
  ``cp.async`` (16 B a copy where the base and strides allow, else 4 B, or
  element by element for unaligned bfloat16) while the current one
  computes, so each input plane comes from device memory once per CTA;
* every op read at an offset is a *root*: it is evaluated once per point
  of its margin-extended plane, ahead of the output by its axis-0 high
  margin, into a float32 ring as deep as the planes it is read at;
  single-plane rings whose lives do not overlap share bytes; an op read
  only at its own point is inlined into the roots that read it as
  value-numbered SSA (the reference's hash-consed CSE);
* roots run level by level, one ``__syncthreads`` between levels; roots
  of a level with equal margins share one loop over their plane, each
  thread computing :data:`POINTS` neighbouring points of a row; the
  zero-boundary mask is applied when a plane is written;
* the generated code is mostly integer index work, so it is kept small:
  loops are not unrolled, per-thread indices are recomputed at each plane
  instead of being held in registers across it, and the launch bounds
  hold ptxas to the registers the planner counted
  (``schedule.BLOCK_REGS``).

Inputs inside an oversized fused-loop carry (``input_pad``) are read
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
from ..core.schedule import COPY_BYTES, BlockCTA, plan_block_cta
from . import build

#: kernel launches made by :class:`GroupCall` (plain-version runs excluded)
launches = 0

#: the TPU kernel this module replaces
REPLACES = "src/repro/kernels/stencil3d.py:202"

#: neighbouring points of a row one thread of the block kernel computes in
#: a loop: they share the index arithmetic, the addresses, the masks and
#: the loads their stencils have in common
POINTS = 2

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

#: what the block and sweep kernels add to the preamble: their asynchronous
#: copies (all of their inline PTX, between the two marker lines) and the
#: plane stager
BLOCK_HELPERS = r"""// ---- PTX helpers: the block kernel's asynchronous copies
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// x, opaque to the compiler: what derives from it is computed where it is
// used, not hoisted into registers held across the sweep's levels
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
// ---- end of PTX helpers
// Columns [x0, x1) of `rows` rows (source row stride s1, shared pitch P),
// E elements of T a copy: asynchronous for 16 and 4 bytes, else a plain
// load and store.  The first copy of a row starts at the E-aligned column
// at or below x0.
template <int E, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long s1,
                                           int rows, int P, int x0, int x1,
                                           int tid, int nt) {
  const int c0 = x0 / E, n = (x1 + E - 1) / E - c0;
#pragma unroll 1
  for (int i = tid; i < rows * n; i += nt) {
    const int r = i / n, x = (c0 + i % n) * E;
    if constexpr (E * sizeof(T) == 16)
      cp_async_16(dst + r * P + x, src + r * s1 + x);
    else if constexpr (E * sizeof(T) == 4)
      cp_async_4(dst + r * P + x, src + r * s1 + x);
    else
      dst[r * P + x] = src[r * s1 + x];
  }
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
        # the CTA: block[0] is the chunk of axis 0 it sweeps (1-D and 2-D
        # programs get unit outer axes)
        self._lift = 3 - ndim
        self.cta: BlockCTA = plan_block_cta(p, self.group, self.block,
                                            self.dtype_name)
        self.smem_bytes = self.cta.smem_bytes
        self.threads = self.cta.threads
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
            ptr = x.data_ptr() + base * self.itemsize
            args += [ptr, strides[0], strides[1],
                     self._copy_bytes(x, ptr, strides, lo[-1])]
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

    def _copy_bytes(self, x, ptr, strides, col) -> int:
        """Bytes one copy of an input's planes moves: 16, else 4, where the
        window's base and outer strides are multiples of it and the copies
        that round a row up to it stay inside the row (``col``: the
        window's first column in ``x``); else one element."""
        for q in (COPY_BYTES, 4):
            e = q // self.itemsize
            if e and ptr % q == 0 \
                    and all(s * self.itemsize % q == 0 for s in strides[:2]) \
                    and col + -(-self.expect[-1] // e) * e <= x.shape[-1]:
                return q
        return self.itemsize

    def _check(self, t, name, device):
        if t.device != device:
            raise ValueError(f"{name!r} is on {t.device}, expected {device}")
        if t.dtype != self.dtype:
            raise ValueError(f"{name!r} has dtype {t.dtype}, expected "
                             f"{self.dtype}")

    # ----------------------------------------------------------- emitting
    def c_argtypes(self) -> list:
        n_in, n_c = len(self.group_inputs), len(self.group_coeffs)
        return ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_int] * n_in
                + [ctypes.c_void_p] * n_c
                + [ctypes.c_void_p] * len(self.group_outputs)
                + [ctypes.c_float] * self.n_scalars
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def kernel_params(self) -> list:
        return kernel_params(self)

    def source(self, name: str | None = None) -> str:
        """CUDA C++ of this group's kernel and its C launch entry."""
        return _emit(self, name or self.entry)

    def flops_per_point(self) -> float:
        """Arithmetic operations the generated code performs per grid
        point, over all CTAs: each loop's value-numbered body on its
        margin-extended plane, warm-up planes and ragged tiles included."""
        return self.cta.traffic(self.grid_shape)[1]

    def staged_bytes_per_point(self) -> float:
        """Bytes the CTAs stage into shared memory per grid point (halo
        planes and rows included)."""
        return self.cta.traffic(self.grid_shape)[0]


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
    """Value-numbered SSA for one loop of the block kernel: the roots of
    one level that share their margins (``loop``), at one point of their
    plane — plane ``q``, tile-relative ``a`` (axis 1) and ``b`` (axis 2),
    global coordinates ``G0``/``G1``/``G2``.

    Every value is numbered by its structure: a load by (buffer, offset),
    an inlined op by (field, offset), an operation by its kind and its
    operands' numbers — so a subtree shared between the roots of the loop
    or the ops inlined into them is emitted once.
    """

    def __init__(self, call: GroupCall, loop):
        self.call = call
        p = call.program
        self.p = p
        self.lift = call._lift
        self.loop = loop
        self.cta = call.cta
        self.ops = {p.ops[i].out: p.ops[i] for i in call.group}
        self.inputs = {r.field: (k, r) for k, r in enumerate(self.cta.inputs)}
        self.rings = {out: j for j, out in enumerate(self.cta.rings)}
        self.coeffs = {c: k for k, c in enumerate(call.group_coeffs)}
        self.scalars = {s: k for k, s in enumerate(p.scalars)}
        self.halo3 = (0,) * self.lift + call.halo_lo
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
        pos = ("q", "t1 + a", "t2 + b")[ax]
        return self._var(("coeff", k, o),
                         f"ld(&cf{k}[{pos} + {self.halo3[ax] + o}])", "f")

    def access(self, e: Access, off: tuple):
        o = tuple(off[a] + v for a, v in
                  enumerate((0,) * self.lift + tuple(int(x) for x in
                                                     e.offset)))
        if e.field in self.inputs:
            k, r = self.inputs[e.field]
            idx = (f"pmod(q + {o[0]}, {r.slots}) * {r.plane} + "
                   f"(a + {o[1] + r.lo[1]}) * {r.pitch} + b + "
                   f"{o[2] + r.lo[2] + r.shift}")
            return self._var(("in", k, o), f"ld(&win{k}[{idx}])", "f")
        if e.field in self.rings:
            ring = self.cta.rings[e.field]
            m = self.cta.margins[e.field]
            slot = (f"pmod(q + {o[0]}, {ring.slots}) * {ring.plane} + "
                    if ring.slots > 1 else "")
            idx = (f"{slot}(a + {o[1] + m[1][0]}) * {ring.extent[1]} + b + "
                   f"{o[2] + m[2][0]}")
            return self._var(("ring", e.field, o),
                             f"op{self.rings[e.field]}[{idx}]", "f")
        return self.temp(e.field, o)

    def _masked(self, field: str, code: str, off: tuple) -> str:
        """``code`` as a zero-boundary op's value at ``off`` from the loop's
        point: 0 outside the global domain, checked on the axes along
        which the loop's plane reaches past its tile."""
        if not self.call.masked[field]:
            return code
        axes = [a for a in range(3) if any(self.loop.margins[a])]
        if not axes:
            return code
        cond = " && ".join(f"(unsigned)(G{a} + ({off[a]})) < "
                           f"{self.extent3[a]}u" for a in axes)
        return f"(({cond}) ? {code} : 0.0f)"

    def temp(self, field: str, off: tuple):
        """The value of the group's op producing ``field`` at ``off``,
        inlined: its result rounded (bfloat16) and masked."""
        key = ("tmp", field, off)
        hit = self.vn.get(key)
        if hit is not None:
            return hit
        r = self.ev(self.ops[field].expr, off)
        code = self._f(r)
        if self.bf16:
            code = f"rnd_bf16({code})"
        code = self._masked(field, code, off)
        if code == r[0] and r[1] == "f":
            self.vn[key] = r
            return r
        return self._var(key, code, "f")

    def root(self, out: str, j: int = 0) -> str:
        """C expression of root ``out`` at the loop's point ``j`` columns
        along axis 2 from ``b``."""
        return self._f(self.temp(out, (0, 0, j)))


def kernel_params(call: GroupCall) -> list:
    """The kernel's parameter declarations, in :meth:`GroupCall.c_argtypes`
    order (without the launch entry's trailing stream)."""
    T = _CTYPE[call.dtype_name]
    params = []
    for k in range(len(call.group_inputs)):
        params += [f"const {T}* __restrict__ in{k}", f"long long in{k}_s0",
                   f"long long in{k}_s1", f"int in{k}_q"]
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
    cta = call.cta
    CH, TA, TB = cta.tile
    N = (1,) * call._lift + call.grid_shape
    tiles = (1,) * call._lift + call.tiles
    H = (0,) * call._lift + call.halo_lo
    tx, ty = cta.threads
    nt = tx * ty
    W = cta.warmup
    outputs = {f: k for k, f in enumerate(call.group_outputs)}
    rings = {out: j for j, out in enumerate(cta.rings)}

    params = kernel_params(call)
    args = [q.split()[-1] for q in params]
    L = [f"// fuse group {call.group} of {call.program.name}: inputs "
         f"[{', '.join(call.group_inputs)}], outputs "
         f"[{', '.join(call.group_outputs)}]",
         f"// CTA: chunk {CH} planes (+{W} warm-up) of a ({TA},{TB}) tile, "
         f"{nt} threads, {len(cta.levels)} levels, {cta.smem_bytes} B "
         "shared memory",
         f"__global__ void __launch_bounds__({nt}, {cta.ctas_per_sm})",
         f"{name}_kernel({', '.join(params)}) {{",
         "  extern __shared__ __align__(16) unsigned char smem_raw[];"]
    for k, r in enumerate(cta.inputs):
        L.append(f"  {T}* win{k} = reinterpret_cast<{T}*>(smem_raw + "
                 f"{r.offset});")
    for out, j in rings.items():
        L.append(f"  float* op{j} = reinterpret_cast<float*>(smem_raw + "
                 f"{cta.rings[out].offset});  // {out}")
    L += [
        "  const int bid = blockIdx.x;",
        f"  const int t2 = (bid % {tiles[2]}) * {TB};",
        f"  const int t1 = ((bid / {tiles[2]}) % {tiles[1]}) * {TA};",
        f"  const int c0 = (bid / {tiles[2] * tiles[1]}) * {CH};",
        f"  const int c1 = min({N[0]}, c0 + {CH});",
        f"  const int vA = min({TA}, {N[1]} - t1), "
        f"vB = min({TB}, {N[2]} - t2);",
        "  const int tid = threadIdx.y * blockDim.x + threadIdx.x;",
        "  (void)vA; (void)vB;",
    ]
    # each input's plane fetch into its ring slot
    for k, r in enumerate(cta.inputs):
        x1 = r.shift + r.lo[2] + TB + r.hi[2]
        stage = (f"(dst, src, in{k}_s1, {r.rows}, {r.pitch}, {r.shift}, "
                 f"{x1}, t, {nt})")
        modes = [(COPY_BYTES, COPY_BYTES // call.itemsize),
                 (4, 4 // call.itemsize)]
        if call.itemsize < 4:
            modes.append((call.itemsize, 1))
        L += [f"  auto fetch{k} = [&](int qq, int t) {{  // {r.field}",
              f"    if (qq < c0 - ({r.lo[0]}) || qq > c1 - 1 + {r.hi[0]}) "
              "return;",
              f"    {T}* dst = win{k} + pmod(qq, {r.slots}) * {r.plane};",
              f"    const {T}* src = in{k} + (long long)(qq + {H[0]}) * "
              f"in{k}_s0 + (long long)(t1 + {H[1] - r.lo[1]}) * in{k}_s1 "
              f"+ (t2 + {H[2] - r.lo[2] - r.shift});"]
        for i, (q, e) in enumerate(modes):
            if i == len(modes) - 1:
                L.append(f"    else stage_rows<{e}>{stage};")
            else:
                L.append(f"    {'else ' if i else ''}if (in{k}_q == {q}) "
                         f"stage_rows<{e}>{stage};")
        L.append("  };")
    L.append(f"  const int z0 = c0 - {W};")
    for k, r in enumerate(cta.inputs):
        L.append(f"  for (int qq = z0 + ({r.low}); qq <= z0 + {r.hi[0]}; "
                 f"++qq) fetch{k}(qq, tid);")
    L += ["  cp_async_commit();",
          "  for (int z = z0; z < c1; ++z) {",
          "    cp_async_wait_all();",
          "    __syncthreads();",
          "    const int tz = opaque(tid);"]
    L += [f"    fetch{k}(z + {r.hi[0] + 1}, tz);"
          for k, r in enumerate(cta.inputs)]
    L.append("    cp_async_commit();")
    for lv, loops in enumerate(cta.levels):
        if lv:
            L.append("    __syncthreads();")
        for loop in loops:
            L += ["    " + x for x in _loop(call, loop, rings, outputs, N,
                                             nt, W)]
    L += ["  }", "}", ""]
    smem = cta.smem_bytes
    L += [
        f'extern "C" int {name}_launch({", ".join(params)}, void* stream) {{',
        "  static bool ready = false;",
        f"  if (!ready && {smem} > 48 * 1024) {{",
        f"    cudaError_t e = cudaFuncSetAttribute({name}_kernel,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize,"
        f" {smem});",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        "  ready = true;",
        f"  {name}_kernel<<<{int(np.prod(tiles))}, dim3({tx}, {ty}), {smem},"
        f" (cudaStream_t)stream>>>({', '.join(args)});",
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ]
    return "\n".join(L)


def _loop(call: GroupCall, loop, rings: dict, outputs: dict, N, nt: int,
          warmup: int) -> list:
    """One loop of the CTA's threads over the plane of ``loop``'s roots,
    :data:`POINTS` neighbouring points of a row a thread: each root's
    value at each point, written into its ring and, for a group output,
    into the output where the point is the chunk's."""
    cta = call.cta
    (_, _), (la, ha), (lb, hb) = loop.margins
    ta, tb = cta.tile[1:]
    ea, eb = ta + la + ha, tb + lb + hb
    nq = -(-eb // POINTS)

    def points() -> list:
        em = _Emitter(call, loop)
        blocks = []
        for j in range(POINTS):
            start = len(em.lines)
            stores = []
            for n, out in enumerate(loop.roots):
                r = f"r{n}_{j}"
                stores.append(f"const float {r} = {em.root(out, j)};")
                if out in rings:
                    ring = cta.rings[out]
                    slot = (f"pmod(q, {ring.slots}) * {ring.plane} + "
                            if ring.slots > 1 else "")
                    stores.append(f"op{rings[out]}[{slot}l + {j}] = {r};")
                if out in outputs:
                    stores += [
                        f"if (q >= c0 && q < c1 && a >= 0 && a < vA && "
                        f"b + {j} >= 0 && b + {j} < vB)",
                        f"  st(&out{outputs[out]}[((long long)q * {N[1]} + "
                        f"t1 + a) * {N[2]} + t2 + b + {j}], {r});"]
            blocks.append([x.strip() for x in em.lines[start:]] + stores)
        # point j exists where the row has j more columns; the points
        # before it exist then too, so their values are in scope
        lines = []
        for j in reversed(range(POINTS)):
            lines = blocks[j] + ([f"if (b + {j + 1} < {eb - lb}) {{"]
                                 + ["  " + x for x in lines] + ["}"]
                                 if lines else [])
        return ["#pragma unroll 1",
                f"for (int i = tz; i < {ea * nq}; i += {nt}) {{",
                f"  const int a = i / {nq} - {la}, "
                f"b = (i % {nq}) * {POINTS} - {lb};",
                f"  const int l = (a + {la}) * {eb} + b + {lb};",
                "  const int G1 = org1 + t1 + a, G2 = org2 + t2 + b;",
                "  (void)l; (void)G1; (void)G2;"] + ["  " + x for x in lines] \
            + ["}"]

    body = [f"const int q = opaque(z + {loop.lead});",
            "const int G0 = org0 + q;",
            "(void)G0;"] + points()
    head = (f"if (z >= c0 - {loop.span}) {{" if loop.span < warmup else "{")
    return ([f"{head}  // {', '.join(loop.roots)}"]
            + ["  " + x for x in body] + ["}"])


# --------------------------------------------------------------------------
# One translation unit per compiled program
# --------------------------------------------------------------------------

class KernelModule:
    """The kernels of one compiled program in one translation unit, built
    by one ``nvcc`` call on first launch."""

    def __init__(self, calls: Sequence[GroupCall]):
        self.calls = list(calls)
        self.source = PREAMBLE + BLOCK_HELPERS + "\n".join(
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
