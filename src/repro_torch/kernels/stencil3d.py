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
through a base offset and the carry's strides; nothing is copied.

A batch of requests (the serving engine's; the reference runs it under
``jax.vmap``, which gives the Pallas grid a batch axis) is one launch: the
batch index is ``blockIdx.y``, every input, coefficient and output pointer
advances by its own batch stride (64-bit), and each element's scalars come
from a ``(batch, n_scalars)`` float32 array on the card, read once at the
CTA's start.  The batch size is a runtime argument, so one build serves
every batch; a single request is a batch of one.  The kernel is a template
on whether the batch has more than one element: moving every pointer to
its element takes registers that ptxas must find under the launch bounds,
which slowed single requests by several per cent on the card, so the
instantiation for one element leaves the pointers as they come.  The C
entry returns ``cudaGetLastError()`` and the wrapper raises if it is not
0.
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

from ..core import boundary as bc
from ..core.expr_eval import evaluate
from ..core.ir import (Access, BinOp, BinOpKind, Cmp, CmpKind, CoeffRef,
                       Const, ScalarRef, Select, UnOp, UnOpKind, Program)
from ..core.passes import GroupHalo, infer_halo
from ..core.schedule import (COPY_BYTES, BlockCTA, plan_block_cta,
                             serving_domain)
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


#: the most elements a batch may have (the launch grid's y extent)
MAX_BATCH = 65535


def batch_of(call, padded_inputs: dict, padded_coeffs: dict | None,
             scalars_vec=None):
    """The batch size of a kernel call's arguments: ``None`` when every
    input has the program's rank (one request), else the leading extent
    that every input, and every coefficient given per element as a
    ``(batch, n)`` array, shares.  A 1-D coefficient serves every
    element.  When no field or coefficient carries a batch, the rows of
    a ``(batch, n)`` ``scalars_vec`` give it (a call that reads nothing,
    or only 1-D coefficients)."""
    sizes, ranks = set(), set()
    for f in call.group_inputs:
        x = padded_inputs[f]
        if x.ndim not in (call.ndim, call.ndim + 1):
            raise ValueError(f"input {f!r} has rank {x.ndim}; expected "
                             f"{call.ndim}, or {call.ndim + 1} with a "
                             "leading batch axis")
        ranks.add(x.ndim)
        if x.ndim > call.ndim:
            sizes.add(int(x.shape[0]))
    for c in call.group_coeffs:
        t = (padded_coeffs or {})[c]
        if t.ndim not in (1, 2):
            raise ValueError(f"coefficient {c!r} has rank {t.ndim}; "
                             "expected 1, or 2 with a leading batch axis")
        if t.ndim == 2:
            sizes.add(int(t.shape[0]))
    if len(ranks) > 1 or len(sizes) > 1:
        raise ValueError(f"the arguments disagree on the batch: ranks "
                         f"{sorted(ranks)}, batch sizes {sorted(sizes)}")
    if not ranks and not sizes and isinstance(
            scalars_vec, torch.Tensor) and scalars_vec.ndim == 2:
        return int(scalars_vec.shape[0])
    return sizes.pop() if sizes else None


def scalar_rows(scalars_vec, n: int, batch: int, device) -> torch.Tensor:
    """A call's scalars as the kernels read them: a contiguous float32
    ``(batch, n)`` tensor on ``device``.  ``scalars_vec`` is a sequence of
    numbers in program order or a ``(m,)`` tensor (the same for every
    element), or a ``(batch, m)`` tensor (a row an element); the first
    ``n`` columns are taken."""
    if isinstance(scalars_vec, torch.Tensor):
        sv = scalars_vec.to(device=device, dtype=torch.float32)
    else:
        sv = torch.tensor([float(v) for v in (scalars_vec or [])],
                          dtype=torch.float32, device=device)
    if sv.ndim == 1:
        sv = sv.unsqueeze(0).expand(batch, -1)
    if sv.ndim != 2 or sv.shape[0] != batch or sv.shape[1] < n:
        raise ValueError(f"expected {n} scalars for each of {batch} "
                         f"elements, got shape {tuple(sv.shape)}")
    return sv[:, :n].contiguous()


def call_device(call, padded_inputs: dict, padded_coeffs, device,
                what: str) -> torch.device:
    """The device a kernel call runs on: its first input's, else its first
    coefficient's, else ``device`` (a group that reads neither)."""
    ref = next((padded_inputs[f] for f in call.group_inputs), None)
    if ref is None:
        ref = next(iter((padded_coeffs or {}).values()), None)
    if ref is not None:
        return ref.device
    if device is None:
        raise ValueError(f"{what} reads no field or coefficient and was "
                         "given no device")
    return torch.device(device)


def per_element(reference, call, padded_inputs: dict, scalars_vec=None,
                padded_coeffs: dict | None = None, origin=None,
                input_pad: dict | None = None, device=None) -> dict:
    """``reference`` (a plain version taking one request's arguments) over
    a batch: each element with its own inputs, coefficients and scalar
    row, the results stacked along a leading axis.  Arguments without a
    batch axis go straight through."""
    padded_coeffs = padded_coeffs or {}
    batch = batch_of(call, padded_inputs, padded_coeffs, scalars_vec)
    if batch is None:
        return reference(call, padded_inputs, scalars_vec, padded_coeffs,
                         origin, input_pad, device)
    two_d = isinstance(scalars_vec, torch.Tensor) and scalars_vec.ndim == 2
    outs = [reference(
        call, {f: x[b] for f, x in padded_inputs.items()},
        scalars_vec[b] if two_d else scalars_vec,
        {c: t[b] if t.ndim == 2 else t for c, t in padded_coeffs.items()},
        origin, input_pad, device) for b in range(batch)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


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

    A leading batch axis on the inputs (and, where they differ per
    element, on the coefficients, ``(B, n)``, and the scalars, ``(B,
    n_scalars)``) runs a batch in one launch and gives outputs of shape
    ``(B, *grid)`` (:func:`batch_of`).
    ``padded_inputs`` must be padded by ``pad_lo``/``pad_hi``; with
    ``input_pad[f]`` an input may be an oversized buffer carrying that
    (ndim, 2) padding, from which the group reads its window in place.
    ``origin`` is the shard's global offset per axis (zeros by default) and
    ``global_extent`` the global domain — together they define the
    out-of-domain mask for margin-extended recompute.
    """

    #: the schedule whose kernels this class generates
    schedule = "block"

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
        # a zero-boundary op's out-of-domain values must read as 0 — on a
        # serving program's bucket at every point, since the real domain is
        # a runtime extent inside it (``schedule.serving_domain``).  Per
        # axis: an op is masked on the axes along which it does not wrap
        self.domain = serving_domain(p)
        self.zero_axes = {op.out: tuple(
            ax for ax in range(ndim)
            if not bc.is_periodic(p.fields[op.out].boundary, ax))
            for op in ops}
        self.masked = {op.out: bool(
            (self.margins[op.out][list(self.zero_axes[op.out])].any()
             or self.domain is not None) and self.zero_axes[op.out])
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
                 input_pad: dict | None = None, device=None) -> dict:
        """Run the group on its inputs' device; ``device`` (the
        orchestrator's) decides for a group that reads no field or
        coefficient."""
        dev = call_device(self, padded_inputs, padded_coeffs, device,
                          "fuse group")
        if dev.type == "cpu":
            return group_call_reference(self, padded_inputs, scalars_vec,
                                        padded_coeffs, origin, input_pad,
                                        device=dev)
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        return launch(self, padded_inputs, scalars_vec, padded_coeffs or {},
                      origin, input_pad or {}, device=dev)

    def kernel_args(self, padded_inputs, sv, padded_coeffs, origin,
                    input_pad, outs) -> list:
        """The kernel's arguments in :meth:`c_argtypes` order (without the
        stream), after checking every tensor's device, dtype, extent and
        layout: a window pointer at its base offset inside each input's
        first element, with the input's strides and its batch stride;
        coefficient pointers with theirs (0 for a 1-D coefficient every
        element shares); output pointers; the ``(B, n_scalars)`` float32
        scalar rows ``sv``; the origin; the batch size B.  Inputs may come
        without the batch axis when B is 1; ``outs`` are ``(B, *grid)``.
        1-D and 2-D programs get unit outer axes."""
        ndim, lift = self.ndim, self._lift
        device, nb = _check_batch(self, sv, outs)
        args = []
        for f in self.group_inputs:
            x = padded_inputs[f]
            self._check(x, f, device)
            x, lo = _window_origin(self, f, x, input_pad, nb)
            base = sum(lo[a] * x.stride(1 + a) for a in range(ndim))
            strides = [0] * lift + [x.stride(1 + a) for a in range(ndim)]
            ptr = x.data_ptr() + base * self.itemsize
            sb = x.stride(0)
            args += [ptr, strides[0], strides[1],
                     self._copy_bytes(x, ptr, strides[:2] + [sb] * (nb > 1),
                                      lo[-1]), sb]
        args += _coeff_args(self, padded_coeffs, device, nb)
        for f in self.group_outputs:
            self._check(outs[f], f, device)
            args.append(outs[f].data_ptr())
        args.append(sv.data_ptr())
        org = [0] * ndim if origin is None else [int(o) for o in origin]
        return args + [0] * lift + org + [nb]

    def _copy_bytes(self, x, ptr, strides, col) -> int:
        """Bytes one copy of an input's planes moves: 16, else 4, where the
        window's base and ``strides`` (the outer ones, and the batch
        stride of a batch of several) are multiples of it, so every
        element's rows start aligned, and the copies that round a row up
        to it stay inside the row (``col``: the window's first column in
        ``x``); else one element."""
        for q in (COPY_BYTES, 4):
            e = q // self.itemsize
            if e and ptr % q == 0 \
                    and all(s * self.itemsize % q == 0 for s in strides) \
                    and col + -(-self.expect[-1] // e) * e <= x.shape[-1]:
                return q
        return self.itemsize

    def count_launch(self) -> None:
        global launches
        launches += 1

    def _check(self, t, name, device):
        if t.device != device:
            raise ValueError(f"{name!r} is on {t.device}, expected {device}")
        if t.dtype != self.dtype:
            raise ValueError(f"{name!r} has dtype {t.dtype}, expected "
                             f"{self.dtype}")

    # ----------------------------------------------------------- emitting
    def c_argtypes(self) -> list:
        return c_argtypes(self)

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


# --------------------------------------------------------------------------
# Launching (shared with the sweep kernel of ``stream3d``)
# --------------------------------------------------------------------------

def launch(call, padded_inputs: dict, scalars_vec, padded_coeffs: dict,
           origin, input_pad: dict, device=None) -> dict:
    """Launch ``call``'s kernel (a :class:`GroupCall` or a
    ``stream3d.StreamCall``) once for the whole batch on the current
    stream: outputs ``(B, *grid)``, or ``grid``-shaped without a batch
    axis.  Raises if the launch fails; counts it in its module's
    ``launches``."""
    if call.dtype_name not in _CTYPE:
        raise NotImplementedError(
            f"the CUDA kernels take float32 or bfloat16, not "
            f"{call.dtype_name}")
    batch = batch_of(call, padded_inputs, padded_coeffs, scalars_vec)
    nb = 1 if batch is None else batch
    if not 1 <= nb <= MAX_BATCH:
        raise ValueError(f"a batch of {nb} elements; the kernels take 1 to "
                         f"{MAX_BATCH}")
    if call.module is None:
        bind([call])
    fn = call.module.function(call.entry)
    device = call_device(call, padded_inputs, padded_coeffs, device,
                         "kernel call")
    outs = {f: torch.empty((nb,) + call.grid_shape, dtype=call.dtype,
                           device=device) for f in call.group_outputs}
    sv = scalar_rows(scalars_vec, call.n_scalars, nb, device)
    args = call.kernel_args(padded_inputs, sv, padded_coeffs, origin,
                            input_pad, outs)
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {call.entry} of "
                           f"{call.program.name!r} failed to launch: "
                           f"cudaError {rc}")
    call.count_launch()
    return outs if batch is not None else {f: o[0] for f, o in outs.items()}


def _check_batch(call, sv, outs) -> tuple:
    """The device and batch size B of a launch, after checking the scalar
    rows ``sv`` (contiguous float32 ``(B, n_scalars)``) and the outputs
    (contiguous ``(B, *grid)``)."""
    device = next(iter(outs.values())).device
    nb = int(sv.shape[0]) if sv.ndim == 2 else -1
    if sv.device != device or sv.dtype != torch.float32 \
            or tuple(sv.shape) != (nb, call.n_scalars) \
            or not sv.is_contiguous():
        raise ValueError(f"scalars must be a contiguous float32 (B, "
                         f"{call.n_scalars}) tensor on {device}, got "
                         f"{sv.dtype} {tuple(sv.shape)} on {sv.device}")
    for f, o in outs.items():
        if tuple(o.shape) != (nb,) + call.grid_shape or \
                not o.is_contiguous():
            raise ValueError(f"output {f!r} must be a contiguous "
                             f"{(nb,) + call.grid_shape} tensor")
    return device, nb


def _window_origin(call, f, x, input_pad, nb) -> tuple:
    """Input ``x`` with its batch axis (added when B is 1 and it has none),
    and its window's first index on each grid axis, after checking that
    the window fits."""
    if x.ndim == call.ndim:
        x = x.unsqueeze(0)
    if x.shape[0] != nb:
        raise ValueError(f"input {f!r} has {x.shape[0]} batch elements, "
                         f"expected {nb}")
    ip = (input_pad or {}).get(f)
    lo = [int(ip[a][0]) - call.halo_lo[a] if ip is not None else 0
          for a in range(call.ndim)]
    for a in range(call.ndim):
        if lo[a] < 0 or x.shape[1 + a] < lo[a] + call.expect[a]:
            raise ValueError(
                f"input {f!r} of shape {tuple(x.shape)} does not hold the "
                f"window extent {call.expect} at offset {tuple(lo)}")
    if x.stride(-1) != 1:
        raise ValueError(f"input {f!r} must be contiguous along its last "
                         "axis")
    return x, lo


def _coeff_args(call, padded_coeffs, device, nb) -> list:
    """Each coefficient's pointer and batch stride: a 1-D array every
    element shares (stride 0), or ``(B, n)`` rows."""
    args = []
    for c in call.group_coeffs:
        t = padded_coeffs[c]
        call._check(t, c, device)
        need = call.expect[call.coeff_axis[c]]
        rows = t.ndim == 2
        if (rows and t.shape[0] != nb) or t.shape[-1] < need \
                or t.stride(-1) != 1:
            raise ValueError(f"coefficient {c!r} must hold at least {need} "
                             "contiguous values, one row a batch element "
                             "where it has two axes")
        args += [t.data_ptr(), t.stride(0) if rows else 0]
    return args


def c_argtypes(call) -> list:
    """ctypes argument types of a kernel's launch entry (the two kernels
    share the layout of :func:`kernel_params`)."""
    n_in, n_c = len(call.group_inputs), len(call.group_coeffs)
    return ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_longlong] * n_in
            + [ctypes.c_void_p, ctypes.c_longlong] * n_c
            + [ctypes.c_void_p] * len(call.group_outputs)
            + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def batch_prologue(call) -> list:
    """The kernel's first lines: the batch element ``bz`` its CTA computes
    (``blockIdx.y``), every pointer moved to that element in the
    ``BATCHED`` instantiation (64-bit offsets: a batch of 8M-point grids
    passes 2^31 elements), and the element's scalars read once into
    ``s0``, ``s1``, ...; for a serving program its real extents ``dn0``,
    ``dn1``, ..."""
    n_out = int(np.prod(call.grid_shape))
    L = ["  const int bz = BATCHED ? (int)blockIdx.y : 0;", "  (void)nb;",
         "  if constexpr (BATCHED) {"]
    L += [f"    in{k} += (long long)bz * in{k}_sb;"
          for k in range(len(call.group_inputs))]
    L += [f"    cf{k} += (long long)bz * cf{k}_sb;"
          for k in range(len(call.group_coeffs))]
    L += [f"    out{k} += (long long)bz * {n_out}LL;"
          for k in range(len(call.group_outputs))]
    L += ["  }"]
    L += [f"  const float s{k} = sv[bz * {call.n_scalars} + {k}];  (void)s{k};"
          for k in range(call.n_scalars)]
    if call.domain is not None:
        # a serving program's real extents, one element's (exact integers)
        L += [f"  const int dn{a} = (int)s{k};"
              for a, k in enumerate(call.domain[1])]
    return L


def kernel_head(name: str, params: list, threads: int, ctas_per_sm: int
                ) -> list:
    """The kernel's declaration: a template on ``BATCHED`` (more than one
    batch element), held by the launch bounds to ``ctas_per_sm`` CTAs of
    ``threads`` an SM."""
    return ["template <bool BATCHED>",
            f"__global__ void __launch_bounds__({threads}, {ctas_per_sm})",
            f"{name}_kernel({', '.join(params)}) {{"]


def launch_entry(name: str, params: list, ctas: int, threads: tuple,
                 smem: int) -> list:
    """The C entry of a kernel: ``ctas`` CTAs along x and the batch along
    y, the one-element instantiation for a batch of one; dynamic shared
    memory above 48 KB opted into once on each device (the attribute is a
    device's); returns ``cudaGetLastError()``."""
    args = ", ".join(q.split()[-1] for q in params)
    cfg = f"dim3({threads[0]}, {threads[1]}), {smem}, (cudaStream_t)stream"
    return [
        f'extern "C" int {name}_launch({", ".join(params)}, void* stream) {{',
        "  static bool ready[64] = {};",
        "  int dev = 0;",
        "  cudaError_t e = cudaGetDevice(&dev);",
        "  if (e != cudaSuccess) return (int)e;",
        "  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;",
        f"  if (!ready[dev] && {smem} > 48 * 1024) {{",
        f"    e = cudaFuncSetAttribute({name}_kernel<false>,",
        f"        cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
        "    if (e == cudaSuccess)",
        f"      e = cudaFuncSetAttribute({name}_kernel<true>,",
        f"          cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        "  ready[dev] = true;",
        "  if (nb == 1)",
        f"    {name}_kernel<false><<<dim3({ctas}, 1), {cfg}>>>({args});",
        "  else",
        f"    {name}_kernel<true><<<dim3({ctas}, nb), {cfg}>>>({args});",
        "  return (int)cudaGetLastError();",
        "}",
        "",
    ]


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
                         origin=None, input_pad: dict | None = None,
                         device=None) -> dict:
    """The group's function in plain PyTorch, on any device: the
    reference's per-tile evaluation with the whole padded output as one
    tile (overlapped tiling is exact, so the tile does not change a value).
    Same arguments and geometry as the kernel, the batch axis included
    (:func:`per_element`), and the same rounding: a bfloat16 group
    computes each op in float32 and rounds its result."""
    return per_element(_group_reference, call, padded_inputs, scalars_vec,
                       padded_coeffs, origin, input_pad, device)


def _group_reference(call: GroupCall, padded_inputs: dict, scalars_vec,
                     padded_coeffs: dict, origin, input_pad,
                     device=None) -> dict:
    """:func:`group_call_reference` for one request."""
    p, ndim, dtype = call.program, call.ndim, call.dtype
    cdt = torch.float32 if dtype == torch.bfloat16 else dtype
    padded_coeffs = padded_coeffs or {}
    block = call.padded_out
    hl = call.halo_lo
    windows = {}
    device = call_device(call, padded_inputs, padded_coeffs, device,
                         "fuse group")
    for f in call.group_inputs:
        x = padded_inputs[f]
        ip = (input_pad or {}).get(f)
        lo = [int(ip[a][0]) - hl[a] if ip is not None else 0
              for a in range(ndim)]
        windows[f] = x[tuple(slice(lo[a], lo[a] + call.expect[a])
                             for a in range(ndim))].to(cdt)
    svec = [] if scalars_vec is None else list(scalars_vec)
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
            for ax in call.zero_axes[op.out]:
                coord = (org[ax] - int(m[ax, 0])
                         + torch.arange(ext[ax], device=device))
                lo, n = 0, call.global_extent[ax]
                if call.domain is not None:
                    lo = call.domain[0][ax]
                    n = int(float(svec[call.domain[1][ax]]))
                ok = (coord >= lo) & (coord < lo + n)
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
        which the loop's plane reaches past its tile (a serving program's:
        0 outside its element's real domain, on every axis), of those
        along which the op does not wrap."""
        if not self.call.masked[field]:
            return code
        zero = {a + self.lift for a in self.call.zero_axes[field]}
        dom = self.call.domain
        if dom is not None:         # every axis, against the real extents
            lo3 = (0,) * self.lift + dom[0]
            cond = " && ".join(
                f"(unsigned)(G{a} + ({off[a] - lo3[a]})) < "
                f"(unsigned)dn{a - self.lift}" for a in range(self.lift, 3)
                if a in zero)
            return f"(({cond}) ? {code} : 0.0f)"
        axes = [a for a in range(3)
                if any(self.loop.margins[a]) and a in zero]
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


def kernel_params(call) -> list:
    """A kernel's parameter declarations, in :func:`c_argtypes` order
    (without the launch entry's trailing stream): each input with its two
    outer strides, copy width and batch stride; each coefficient with its
    batch stride; the outputs; the scalar rows; the origin; the batch
    size (the block and the sweep kernel alike)."""
    T = _CTYPE.get(call.dtype_name, "float")
    params = []
    for k in range(len(call.group_inputs)):
        params += [f"const {T}* __restrict__ in{k}", f"long long in{k}_s0",
                   f"long long in{k}_s1", f"int in{k}_q",
                   f"long long in{k}_sb"]
    for k in range(len(call.group_coeffs)):
        params += [f"const {T}* __restrict__ cf{k}", f"long long cf{k}_sb"]
    params += [f"{T}* __restrict__ out{k}"
               for k in range(len(call.group_outputs))]
    params += ["const float* __restrict__ sv"]
    params += ["int org0", "int org1", "int org2", "int nb"]
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
    L = [f"// fuse group {call.group} of {call.program.name}: inputs "
         f"[{', '.join(call.group_inputs)}], outputs "
         f"[{', '.join(call.group_outputs)}]",
         f"// CTA: chunk {CH} planes (+{W} warm-up) of a ({TA},{TB}) tile, "
         f"{nt} threads, {len(cta.levels)} levels, {cta.smem_bytes} B "
         "shared memory"]
    L += kernel_head(name, params, nt, cta.ctas_per_sm)
    L += ["  extern __shared__ __align__(16) unsigned char smem_raw[];"]
    for k, r in enumerate(cta.inputs):
        L.append(f"  {T}* win{k} = reinterpret_cast<{T}*>(smem_raw + "
                 f"{r.offset});")
    for out, j in rings.items():
        L.append(f"  float* op{j} = reinterpret_cast<float*>(smem_raw + "
                 f"{cta.rings[out].offset});  // {out}")
    L += batch_prologue(call)
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
    L += launch_entry(name, params, int(np.prod(tiles)), (tx, ty),
                      cta.smem_bytes)
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
