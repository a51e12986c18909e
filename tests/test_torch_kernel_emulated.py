"""The generated CUDA fuse-group kernel, run on the CPU through the host C++
compiler.

The kernel source from ``repro_torch.kernels.stencil3d`` is compiled by
``g++`` against a small shim that stands in for the CUDA runtime: every
CTA runs its threads as host threads, ``__syncthreads`` is a barrier, and
shared memory is a per-CTA buffer.  This runs the emitter's own code —
staging, window indexing, masks, coefficient reads, bfloat16 rounding,
carry base offsets — and holds it against the plain PyTorch version, on
tiny grids.  It skips where no host C++ compiler is installed.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.apps import pw_advection, tracer_advection
from repro_torch.core import boundary as bc
from repro_torch.core.schedule import auto_plan
from repro_torch.kernels import stencil3d

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::fabs; using std::fmin; using std::fmax;
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
thread_local dim3 threadIdx, blockIdx;
thread_local std::barrier<>* emu_bar;
thread_local unsigned char* emu_smem;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
#define __align__(x)
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
struct __nv_bfloat16 { uint16_t b; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.b << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u); return {(uint16_t)(u >> 16)}; }
"""


def _emulated(call):
    """ctypes entry running ``call``'s generated kernel on host threads."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the generated kernel")
    src = stencil3d.PREAMBLE + call.source("g0")
    src = src.split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    params = stencil3d.kernel_params(call)
    names = ", ".join(q.split()[-1] for q in params)
    src += f"""
extern "C" int emu_launch({', '.join(params)}, int nblocks, int tx, int ty,
                          int smem) {{
  for (int b = 0; b < nblocks; ++b) {{
    std::vector<unsigned char> sm(smem);
    std::barrier<> bar(tx * ty);
    std::vector<std::thread> ts;
    for (int y = 0; y < ty; ++y)
      for (int x = 0; x < tx; ++x)
        ts.emplace_back([&, x, y, b] {{
          threadIdx = dim3(x, y); blockIdx = dim3(b);
          emu_bar = &bar; emu_smem = sm.data();
          g0_kernel({names});
        }});
    for (auto& t : ts) t.join();
  }}
  return 0;
}}
"""
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "repro_torch_emu")
    os.makedirs(os.path.join(d, "inc"), exist_ok=True)
    for h in ("cuda_runtime.h", "cuda_bf16.h"):
        open(os.path.join(d, "inc", h), "w").close()
    shim = os.path.join(d, "shim.h")
    with open(shim, "w") as fh:
        fh.write(SHIM)
    so = os.path.join(d, f"emu_{tag}.so")
    if not os.path.exists(so):
        cc = os.path.join(d, f"emu_{tag}.cc")
        with open(cc, "w") as fh:
            fh.write(src)
        tmp = so + f".{os.getpid()}"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-ffp-contract=off", "-include", shim,
                        "-I", os.path.join(d, "inc"), "-o", tmp, cc],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    fn = ctypes.CDLL(so).emu_launch
    fn.argtypes = call.c_argtypes()[:-1] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def run_emulated(call, padded, svec, pcoeffs, origin=None, input_pad=None):
    """The kernel launched as ``GroupCall._launch`` launches it (the same
    argument marshalling), on CPU tensors, through the emulated entry."""
    fn = _emulated(call)
    outs = {f: torch.full(call.grid_shape, float("nan"), dtype=call.dtype)
            for f in call.group_outputs}
    args = call.kernel_args(padded, svec, pcoeffs, origin, input_pad, outs)
    tx, ty = call.threads
    fn(*args, int(np.prod(call.tiles)), tx, ty, call.smem_bytes)
    return outs


def _inputs(p, grid, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = {k: torch.as_tensor(rng.normal(size=grid).astype(np.float32))
         for k in p.input_fields()}
    if "e3t" in f:
        f["e3t"] = f["e3t"].abs() + 1.0
    if "msk" in f:
        f["msk"] = (f["msk"] > 0).float()
    f = {k: v.to(dtype) for k, v in f.items()}
    svec = [0.1, 1e-6][:len(p.scalars)]
    c = {k: torch.as_tensor(rng.normal(size=(grid[ax],)).astype(np.float32)
                            ).to(dtype) for k, ax in p.coeffs.items()}
    return f, svec, c


def _pad_all(p, call, f, c):
    bnd = p.boundaries()
    padded = {k: bc.pad_field(f[k], call.halo_lo, call.halo_hi, bnd[k],
                              align_hi=call.align_hi).contiguous()
              for k in call.group_inputs}
    pc = {k: bc.pad_coeff(c[k], call.pad_lo[call.coeff_axis[k]],
                          call.pad_hi[call.coeff_axis[k]],
                          bc.coeff_mode(p)).contiguous()
          for k in call.group_coeffs}
    return padded, pc


CASES = [
    (pw_advection, "zero", torch.float32, (2, 4, 32), 0.0),
    (pw_advection, "periodic", torch.float32, (2, 4, 32), 0.0),
    (pw_advection, "zero", torch.bfloat16, (2, 4, 32), 0.0),
    (tracer_advection, "zero", torch.float32, (1, 4, 32), 1e-5),
    (tracer_advection, "periodic", torch.float32, (1, 4, 32), 1e-5),
]


@pytest.mark.parametrize("app,boundary,dtype,block,tol", CASES)
def test_generated_kernel_matches_plain_version(app, boundary, dtype, block,
                                                tol):
    """Kernel vs plain version on a grid that is not a tile multiple, so
    alignment slabs, hi-side masks and every tile edge are exercised.
    Tolerances are relative to each field's max abs.  pw_advection, in
    float32 and in bfloat16 (both round each op's float32 result), must
    match exactly: the host build does not contract into FMAs.
    tracer_advection to 1e-5: the kernel evaluates the same operations,
    in another association only where value numbering shares a
    subtree."""
    p = app(boundary)
    grid = (5, 6, 40)
    call = stencil3d.build_group_call(p, auto_plan(p, grid).groups[0], block,
                                      grid, dtype=dtype)
    f, svec, c = _inputs(p, grid, dtype)
    padded, pc = _pad_all(p, call, f, c)
    want = stencil3d.group_call_reference(call, padded, svec, pc)
    got = run_emulated(call, padded, svec, pc)
    for k in want:
        w, g = want[k].float(), got[k].float()
        scale = float(w.abs().max())
        assert torch.isfinite(g).all(), k
        assert float((g - w).abs().max()) <= tol * scale, k


def test_generated_kernel_reads_windows_inside_an_oversized_carry():
    """``input_pad``: the window is read through a base offset and the
    carry's strides, with a different halo than the group's own."""
    p = tracer_advection()
    grid = (5, 6, 40)
    call = stencil3d.build_group_call(p, auto_plan(p, grid).groups[0],
                                      (1, 4, 32), grid)
    f, svec, c = _inputs(p, grid, torch.float32, seed=3)
    padded, pc = _pad_all(p, call, f, c)
    extra = np.array([[2, 1], [1, 3], [3, 2]])
    fpad = {k: np.stack([np.array(call.halo_lo), np.array(call.pad_hi)], 1)
            + extra for k in call.group_inputs}
    carry = {k: bc.pad_field(f[k], fpad[k][:, 0], fpad[k][:, 1],
                             "zero").contiguous()
             for k in call.group_inputs}
    want = stencil3d.group_call_reference(call, padded, svec, pc)
    got = run_emulated(call, carry, svec, pc, input_pad=fpad)
    torch.testing.assert_close(got["ta"], want["ta"], atol=1e-5, rtol=1e-5)


def test_generated_kernel_masks_against_the_global_domain():
    """A shard at a non-zero origin inside a larger global domain: only
    margins outside the *global* extent read as zero."""
    p = tracer_advection()
    grid = (5, 6, 40)
    call = stencil3d.build_group_call(p, auto_plan(p, grid).groups[0],
                                      (1, 4, 32), grid,
                                      global_extent=(12, 6, 72))
    f, svec, c = _inputs(p, grid, torch.float32, seed=4)
    padded, pc = _pad_all(p, call, f, c)
    origin = (4, 0, 32)
    want = stencil3d.group_call_reference(call, padded, svec, pc,
                                          origin=origin)
    got = run_emulated(call, padded, svec, pc, origin=origin)
    torch.testing.assert_close(got["ta"], want["ta"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grid,block", [((70,), (32,)), ((9, 45), (4, 32))])
def test_generated_kernel_lifts_1d_and_2d_programs(grid, block):
    """1-D and 2-D programs run as 3-D kernels with unit outer axes; a
    temp read at offsets exercises masks and margins on every axis."""
    from repro_torch.core.frontend import ProgramBuilder

    nd = len(grid)
    b = ProgramBuilder("lifted", ndim=nd)
    x = b.input("x")
    t = b.temp("t")
    o = b.output("o")
    z = (0,) * nd
    lo = tuple(-1 if a == nd - 1 else 0 for a in range(nd))
    hi = tuple(1 if a == 0 else 0 for a in range(nd))
    b.define(t, x[z] * 2.0 + x[hi] - x[lo])
    b.define(o, t[hi] * t[lo] + t[z])
    p = b.build()
    call = stencil3d.build_group_call(p, [0, 1], block, grid)
    rng = np.random.default_rng(7)
    padded = {"x": bc.pad_field(
        torch.as_tensor(rng.normal(size=grid).astype(np.float32)),
        call.halo_lo, call.halo_hi, "zero",
        align_hi=call.align_hi).contiguous()}
    want = stencil3d.group_call_reference(call, padded, [], {})
    got = run_emulated(call, padded, [], {})
    torch.testing.assert_close(got["o"], want["o"], atol=1e-6, rtol=1e-6)
