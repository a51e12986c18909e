"""The generated CUDA kernels, run on the CPU through the host C++
compiler.

The kernel sources from ``repro_torch.kernels.stencil3d`` (fuse groups)
and ``repro_torch.kernels.stream3d`` (stream sweeps) are compiled by
``g++`` against a small shim that stands in for the CUDA runtime: every
CTA runs its threads as host threads, ``__syncthreads`` is a barrier, and
shared memory is a per-CTA buffer.  This runs the emitters' own code —
staging, window indexing, rings, chain stages, masks, coefficient reads,
bfloat16 rounding, carry base offsets, chunked sweeps — and holds it
against the plain PyTorch versions, on tiny grids.  It skips where no host
C++ compiler is installed.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection)
from repro_torch.core import boundary as bc
from repro_torch.core.dataflow import lower_to_dataflow
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.lower_stream import trace_update
from repro_torch.core.schedule import adapt_update, auto_plan
from repro_torch.kernels import stencil3d
from repro_torch.kernels.stream3d import StreamCall, stream_call_reference

SHIM = r"""
#include <barrier>
#include <cmath>
#include <deque>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::fabs; using std::fmin; using std::fmax; using std::min;
using std::max;
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local std::barrier<>* emu_bar;
thread_local unsigned char* emu_smem;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
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


# host versions of the kernels' PTX helpers: a copy lands at once
HOST_COPIES = r"""
inline void cp_async_16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async_4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline int opaque(int x) { return x; }
"""
# ... or a copy is queued by the thread that starts it (its source read at
# once) and lands only when that thread waits for its group: a plane read
# before its wait, or a slot fetched into while another thread still reads
# it, shows
QUEUED_HOST_COPIES = r"""
struct EmuCopy { void* dst; unsigned char b[16]; int n; };
thread_local std::vector<EmuCopy> emu_open;
thread_local std::deque<std::vector<EmuCopy>> emu_groups;
inline void emu_queue(void* dst, const void* src, int n) {
  EmuCopy c; c.dst = dst; c.n = n; std::memcpy(c.b, src, n);
  emu_open.push_back(c); }
inline void emu_land_oldest() {
  for (auto& c : emu_groups.front()) std::memcpy(c.dst, c.b, c.n);
  emu_groups.pop_front(); }
inline void cp_async_16(void* dst, const void* src) { emu_queue(dst, src, 16); }
inline void cp_async_4(void* dst, const void* src) { emu_queue(dst, src, 4); }
inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open)); emu_open.clear(); }
inline void cp_async_wait_all() {
  cp_async_commit(); while (!emu_groups.empty()) emu_land_oldest(); }
inline int opaque(int x) { return x; }
"""
HELPERS_BEGIN, HELPERS_END = "// ---- PTX helpers", "// ---- end of PTX helpers"


def _helpers(queued=False):
    """``stencil3d.BLOCK_HELPERS`` with its PTX helpers block swapped for
    :data:`HOST_COPIES` (or :data:`QUEUED_HOST_COPIES`)."""
    head, rest = stencil3d.BLOCK_HELPERS.split(HELPERS_BEGIN)
    return (head + (QUEUED_HOST_COPIES if queued else HOST_COPIES)
            + rest.split(HELPERS_END)[1])


def _emulated(call, queued=False):
    """ctypes entry running ``call``'s generated kernel on host threads.
    Shared memory starts as 0xff bytes (NaN), so a read of a plane that
    was never fetched or written shows in the result.  ``queued``: the
    asynchronous copies land at their wait, not at once."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the generated kernel")
    src = stencil3d.PREAMBLE + _helpers(queued)
    src += call.source("g0")
    src = src.split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    params = call.kernel_params()
    names = ", ".join(q.split()[-1] for q in params)
    src += f"""
extern "C" int emu_launch({', '.join(params)}, int nblocks, int tx, int ty,
                          int smem) {{
  for (int z = 0; z < nb; ++z)
  for (int b = 0; b < nblocks; ++b) {{
    std::vector<unsigned char> sm(smem, 0xff);
    std::barrier<> bar(tx * ty);
    std::vector<std::thread> ts;
    for (int y = 0; y < ty; ++y)
      for (int x = 0; x < tx; ++x)
        ts.emplace_back([&, x, y, b, z] {{
          threadIdx = dim3(x, y); blockIdx = dim3(b, z);
          blockDim = dim3(tx, ty);
          emu_bar = &bar; emu_smem = sm.data();
          if (nb == 1) g0_kernel<false>({names});
          else g0_kernel<true>({names});
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


def _emulated_launch(call, nblocks, padded, svec, pcoeffs, origin,
                     input_pad, queued=False):
    """The kernel launched as ``stencil3d.launch`` launches it (the same
    argument marshalling, a batch axis or none), on CPU tensors, through
    the emulated entry."""
    fn = _emulated(call, queued)
    batch = stencil3d.batch_of(call, padded, pcoeffs, svec)
    nb = 1 if batch is None else batch
    outs = {f: torch.full((nb,) + call.grid_shape, float("nan"),
                          dtype=call.dtype) for f in call.group_outputs}
    sv = stencil3d.scalar_rows(svec, call.n_scalars, nb, "cpu")
    args = call.kernel_args(padded, sv, pcoeffs, origin, input_pad, outs)
    tx, ty = call.threads
    fn(*args, nblocks, tx, ty, call.smem_bytes)
    return outs if batch is not None else {f: o[0] for f, o in outs.items()}


def run_emulated(call, padded, svec, pcoeffs, origin=None, input_pad=None):
    """The block kernel through the emulated entry."""
    return _emulated_launch(call, int(np.prod(call.tiles)), padded, svec,
                            pcoeffs, origin, input_pad)


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
    (tracer_advection, "zero", torch.bfloat16, (2, 4, 32), 2e-2),
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


# (app, boundary, dtype, grid, block, global extent, origin, carry padding
# added to each side of every input, tolerance): axis 0 cut into chunks of 4
# planes with a ragged last one (11 = 4 + 4 + 3) and ragged tiles on axes 1
# and 2; a shard whose chunks' warm-up planes cross the global domain's low
# edge (origin 2) and whose last chunk ends at its high edge; a shard
# inside the domain, whose margins on most planes and tiles do not leave
# it; windows inside
# oversized carries (extra padding per axis and side), which take the
# 4-byte copies (float32 rows of 75 elements, bfloat16 of 70) and the
# element-wise ones (bfloat16 rows of 75)
SWEEP_CASES = [
    (tracer_advection, "zero", torch.float32, None, None, None, 1e-5),
    (tracer_advection, "periodic", torch.float32, None, None, None, 1e-5),
    (tracer_advection, "zero", torch.float32, (13, 6, 72), (2, 0, 32), None,
     1e-5),
    (tracer_advection, "zero", torch.float32, (24, 24, 80), (4, 8, 16), None,
     1e-5),
    (tracer_advection, "zero", torch.float32, None, None,
     ((1, 2), (2, 1), (1, 2)), 1e-5),
    (tracer_advection, "zero", torch.bfloat16, None, None,
     ((1, 2), (2, 1), (1, 2)), 2e-2),
    (pw_advection, "zero", torch.bfloat16, None, None,
     ((2, 1), (1, 1), (2, 2)), 0.0),
    (pw_advection, "periodic", torch.float32, None, None, None, 0.0),
]


@pytest.mark.parametrize("app,boundary,dtype,extent,origin,extra,tol",
                         SWEEP_CASES)
def test_generated_kernel_sweeps_chunks_of_axis_0(app, boundary, dtype,
                                                  extent, origin, extra, tol):
    """Kernel vs plain version with the stream axis cut into chunks, each
    CTA warming up below its chunk: rings across chunk starts, the
    zero-boundary mask on warm-up planes against the global domain, and
    the copies of carry windows.  Tolerances as in
    :func:`test_generated_kernel_matches_plain_version` (bfloat16 2e-2)."""
    p = app(boundary)
    grid = (11, 6, 40)
    call = stencil3d.build_group_call(p, auto_plan(p, grid).groups[0],
                                      (4, 4, 32), grid, dtype=dtype,
                                      global_extent=extent)
    assert call.tiles == (3, 2, 2)
    f, svec, c = _inputs(p, grid, dtype, seed=11)
    padded, pc = _pad_all(p, call, f, c)
    ipad = None
    got_in = padded
    if extra is not None:
        ipad = {k: np.stack([np.array(call.halo_lo), np.array(call.pad_hi)],
                            1) + np.array(extra) for k in call.group_inputs}
        got_in = {k: bc.pad_field(f[k], ipad[k][:, 0], ipad[k][:, 1],
                                  "zero").contiguous()
                  for k in call.group_inputs}
        # the windows sit inside the carries; their halos match the plain
        # version's padded inputs (zero boundary), so both see equal data
        for k in call.group_inputs:
            win = got_in[k][tuple(slice(int(ipad[k][a, 0]) - call.halo_lo[a],
                                        int(ipad[k][a, 0]) - call.halo_lo[a]
                                        + call.expect[a]) for a in range(3))]
            assert torch.equal(win, padded[k])
    want = stencil3d.group_call_reference(call, padded, svec, pc,
                                          origin=origin)
    got = run_emulated(call, got_in, svec, pc, origin=origin,
                       input_pad=ipad)
    for k in want:
        w, g = want[k].float(), got[k].float()
        assert torch.isfinite(g).all(), k
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()), k


def test_copy_sizes_follow_the_layout():
    """16-byte copies where the window's base and strides allow, 4-byte
    ones where they allow those, element by element else (bfloat16)."""
    p = pw_advection()
    grid = (4, 6, 40)
    for dtype, width, want in [(torch.float32, 68, 16),
                               (torch.float32, 69, 4),
                               (torch.bfloat16, 72, 16),
                               (torch.bfloat16, 70, 4),
                               (torch.bfloat16, 69, 2)]:
        call = stencil3d.build_group_call(p, [0, 1, 2], (4, 4, 32), grid,
                                          dtype=dtype)
        f, svec, c = _inputs(p, grid, dtype)
        padded, pc = _pad_all(p, call, f, c)
        # rows of ``width`` elements (the window's are 66)
        x = {k: torch.nn.functional.pad(v, (0, width - v.shape[-1]))
             for k, v in padded.items()}
        outs = {o: torch.empty((1,) + grid, dtype=dtype)
                for o in call.group_outputs}
        sv = stencil3d.scalar_rows(svec, call.n_scalars, 1, "cpu")
        args = call.kernel_args(x, sv, pc, None, None, outs)
        assert args[3] == want, (dtype, width)
    # and each is taken by the sweep cases' carries: rows of 75 float32
    # elements (4 bytes), 70 and 75 bfloat16 ones (4 bytes, element-wise)


# --------------------------------------------------------------------------
# The stream sweep kernel
# --------------------------------------------------------------------------

def run_stream_emulated(call, padded, svec, pcoeffs, origin=None,
                        input_pad=None, queued=False):
    """The sweep kernel through the emulated entry (``queued``: its copies
    land at their wait)."""
    return _emulated_launch(call, call.cta.ctas, padded, svec, pcoeffs,
                            origin, input_pad, queued)


def _stream_calls(app, boundary, grid, dtype=torch.float32, time_tile=1,
                  plane_tile=1, tile=None, chunk=None):
    """One StreamCall per region of the app's stream plan (a chain for
    ``time_tile > 1``)."""
    p = app(boundary)
    plan = auto_plan(p, grid, schedule="stream", time_tile=time_tile,
                     plane_tile=plane_tile)
    graph = lower_to_dataflow(p, plan, grid)
    calls = []
    for r in graph.regions:
        kw = {}
        if time_tile > 1:
            upd = adapt_update(pw_advection_update(0.1))
            outs = [p.ops[i].out for i in r.ops]
            exprs, why = trace_update(p, upd, r.halo.group_inputs, outs)
            assert why is None, why
            kw = dict(time_tile=time_tile, update=upd, update_exprs=exprs)
        calls.append(StreamCall(p, r, grid, dtype=dtype,
                                plane_tile=graph.plane_tile, tile=tile,
                                chunk=chunk, **kw))
    return p, calls


def _stream_inputs(p, call, grid, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    bnd = p.boundaries()
    padded = {}
    for k in call.group_inputs:
        x = torch.as_tensor(rng.normal(size=grid).astype(np.float32)) * scale
        if k == "e3t":
            x = x.abs() + 1.0
        if k == "msk":
            x = (x > 0).float()
        padded[k] = bc.pad_field(x.to(dtype), call.pad_lo, call.pad_hi,
                                 bnd.get(k, "zero")).contiguous()
    pc = {k: bc.pad_coeff(torch.as_tensor(rng.normal(
        size=(grid[call.coeff_axis[k]],)).astype(np.float32)).to(dtype),
        call.pad_lo[call.coeff_axis[k]], call.pad_hi[call.coeff_axis[k]],
        bc.coeff_mode(p)).contiguous() for k in call.group_coeffs}
    svec = [0.1, 1e-6][:len(p.scalars)]
    return padded, svec, pc


STREAM_CASES = [
    # app, boundary, dtype, time_tile, plane_tile, tile, chunk
    (pw_advection, "zero", torch.float32, 1, 1, None, None),
    (pw_advection, "periodic", torch.float32, 1, 1, None, None),
    (pw_advection, "zero", torch.bfloat16, 1, 1, None, None),
    (pw_advection, "zero", torch.float32, 2, 1, None, None),
    (pw_advection, "zero", torch.float32, 1, 2, None, None),
    # a tile smaller than the plane, and the sweep cut into chunks
    (pw_advection, "zero", torch.float32, 1, 1, (2, 32), 3),
    (pw_advection, "zero", torch.float32, 2, 2, (4, 32), 4),
    (tracer_advection, "zero", torch.float32, 1, 1, None, None),
    (tracer_advection, "zero", torch.float32, 1, 1, (2, 32), 3),
    # eight regions; a four-stage chain cut into chunks
    (tracer_advection, "periodic", torch.float32, 1, 1, None, None),
    (pw_advection, "zero", torch.float32, 4, 1, (4, 32), 4),
]


def _check_sweep_case(app, boundary, dtype, time_tile, plane_tile, tile,
                      chunk, queued=False):
    grid = (7, 6, 40)
    p, calls = _stream_calls(app, boundary, grid, dtype, time_tile,
                             plane_tile, tile, chunk)
    tol = 0.0 if p.name == "pw_advection" else 1e-6
    for k, call in enumerate(calls):
        padded, svec, pc = _stream_inputs(p, call, grid, dtype, seed=k,
                                          scale=0.1 if time_tile > 1 else 1)
        want = stream_call_reference(call, padded, svec, pc)
        got = run_stream_emulated(call, padded, svec, pc, queued=queued)
        for f in want:
            w, g = want[f].float(), got[f].float()
            assert torch.isfinite(g).all(), (k, f)
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= tol * scale, (k, f)


@pytest.mark.parametrize("app,boundary,dtype,time_tile,plane_tile,tile,chunk",
                         STREAM_CASES)
def test_generated_sweep_kernel_matches_plain_version(
        app, boundary, dtype, time_tile, plane_tile, tile, chunk):
    """Sweep kernel vs plain version, every region of the plan, on a grid
    whose plane is not a multiple of the CTA tile.  Tolerances relative to
    each field's max abs: float32 and bfloat16 exact for pw_advection (the
    host build does not contract into FMAs and both round each op), 1e-6
    for tracer_advection (value numbering may share a subtree in another
    association)."""
    _check_sweep_case(app, boundary, dtype, time_tile, plane_tile, tile,
                      chunk)


@pytest.mark.parametrize("app,boundary,dtype,time_tile,plane_tile,tile,chunk",
                         STREAM_CASES)
def test_generated_sweep_kernel_with_queued_copies_matches_plain_version(
        app, boundary, dtype, time_tile, plane_tile, tile, chunk):
    """The same cases with each copy landing only when its thread waits
    for it: a plane read before its wait, a slot fetched into before
    every thread has read it, or a ring too shallow for the planes in
    flight shows.  Tolerances as above."""
    _check_sweep_case(app, boundary, dtype, time_tile, plane_tile, tile,
                      chunk, queued=True)


def _coeff_ring(boundary="zero"):
    """t = cf0<0>; o3 = t[-1,0,0]: a ring fed by a coefficient alone, so
    the region reads no field and its warm-up planes come from the ring's
    stream margin alone."""
    b = ProgramBuilder("coeff_ring", ndim=3, boundary=boundary)
    b.inputs("in0")
    cf0 = b.coeff("cf0", axis=2)
    t = b.temp("t")
    (o3,) = b.outputs("o3")
    b.define(t, cf0[0])
    b.define(o3, t[-1, 0, 0])
    return b.build()


def _coeff_ring_chain(boundary="zero"):
    """o2 = cf0<-1> * cf0<-1>; o3 = o2[-2,2,-1] * o2[-2,2,-1]: a ring read
    two planes back, fed by a coefficient alone."""
    b = ProgramBuilder("coeff_ring_chain", ndim=3, boundary=boundary)
    b.inputs("in0")
    cf0 = b.coeff("cf0", axis=2)
    o2 = b.temp("o2")
    (o3,) = b.outputs("o3")
    b.define(o2, cf0[-1] * cf0[-1])
    b.define(o3, o2[-2, 2, -1] * o2[-2, 2, -1])
    return b.build()


# app, boundary, time_tile, tile, chunk, origin on axis 0 of a global
# extent of three shards: the first, a middle and the last shard, a chain
# with its T-fold ghost planes, chunks whose warm-up reaches below the
# shard's first plane (and below its padded input), and regions that read
# no field, whose rings a coefficient feeds
SHARDED_SWEEP_CASES = [
    (pw_advection, "zero", 1, None, None, 7),
    (pw_advection, "zero", 1, (2, 32), 3, 0),
    (pw_advection, "zero", 2, (4, 32), 2, 7),
    (pw_advection, "zero", 2, None, None, 14),
    (pw_advection, "periodic", 1, (4, 32), 3, 7),
    (tracer_advection, "zero", 1, (2, 32), 3, 7),
    (tracer_advection, "zero", 1, None, None, 14),
    (_coeff_ring, "zero", 1, None, None, 7),
    (_coeff_ring, "zero", 1, (2, 32), 3, 14),
    (_coeff_ring_chain, "zero", 1, (4, 32), 2, 7),
]


@pytest.mark.parametrize("app,boundary,time_tile,tile,chunk,origin",
                         SHARDED_SWEEP_CASES)
@pytest.mark.parametrize("queued", [False, True])
def test_generated_sweep_kernel_over_a_sharded_stream_axis(
        app, boundary, time_tile, tile, chunk, origin, queued):
    """A shard's sweep when a mesh cuts the stream axis
    (``stream_sharded``): the input carries the deeper lo-side ghost
    planes, the planes below the shard's first plane lie in the global
    domain, and every chunk warms up below its first plane, the first
    one reading planes before the padded input as zeros.  Kernel vs plain
    version at the plain sweep's tolerances (pw exact, tracer 1e-6)."""
    grid = (7, 6, 40)
    p = app(boundary)
    plan = auto_plan(p, grid, schedule="stream", time_tile=time_tile)
    graph = lower_to_dataflow(p, plan, grid, stream_sharded=True)
    tol = 0.0 if p.name == "pw_advection" else 1e-6
    for k, r in enumerate(graph.regions):
        kw = {}
        if time_tile > 1:
            upd = adapt_update(pw_advection_update(0.1))
            outs = [p.ops[i].out for i in r.ops]
            exprs, why = trace_update(p, upd, r.halo.group_inputs, outs)
            assert why is None, why
            kw = dict(time_tile=time_tile, update=upd, update_exprs=exprs)
        call = StreamCall(p, r, grid, global_extent=(21, 6, 40), tile=tile,
                          chunk=chunk, stream_sharded=True, **kw)
        assert call.halo_lo[0] == time_tile * int(r.halo.input_halo[0, 0])
        _, svec, pc = _stream_inputs(p, call, grid, torch.float32, seed=k)
        # the ghost planes hold a neighbour's data: random, like the rest
        rng = np.random.default_rng(k)
        padded = {}
        for f in call.group_inputs:
            x = torch.as_tensor(rng.normal(size=call.expect)
                                .astype(np.float32)) * 0.1
            padded[f] = ((x > 0).float() if f == "msk" else
                         x.abs() + 1.0 if f == "e3t" else x)
        org = (origin, 0, 0)
        want = stream_call_reference(call, padded, svec, pc, origin=org)
        got = run_stream_emulated(call, padded, svec, pc, origin=org,
                                  queued=queued)
        for f in want:
            w, g = want[f].float(), got[f].float()
            assert torch.isfinite(g).all(), (k, f)
            assert float((g - w).abs().max()) <= tol * float(
                w.abs().max()), (k, f)


def _coeff_program(ndim):
    """A ring temp read one plane back and a coefficient along the stream
    axis read at offsets -1, 0, +1 (3-D: also one along axis 1)."""
    b = ProgramBuilder(f"zcoef{ndim}", ndim=ndim)
    x = b.input("x")
    cz = b.coeff("cz", axis=0)
    t = b.temp("t")
    o = b.output("o")
    z = (0,) * ndim
    back = (-1,) + (0,) * (ndim - 1)
    fwd = (1,) + (0,) * (ndim - 1)
    side = (0,) * (ndim - 1) + (-1,)
    up = (0, 1) + (0,) * (ndim - 2)
    extra = x[side] if ndim == 2 else x[side] * b.coeff("cy", axis=1)[0]
    b.define(t, x[z] * cz[0] + x[back] - extra)
    b.define(o, t[back] * cz[1] + t[up] - x[fwd] * cz[-1])
    return b.build()


@pytest.mark.parametrize("ndim,grid,tile,chunk", [
    (3, (7, 6, 40), (2, 32), 3),
    (2, (9, 45), (32,), 4),
])
def test_generated_sweep_kernel_coefficients_and_2d_lift(ndim, grid, tile,
                                                         chunk):
    """Axis-0 coefficients at the clamped per-plane index, a temp ring
    across chunks, and a 2-D program run with a unit lifted axis."""
    p = _coeff_program(ndim)
    plan = auto_plan(p, grid, schedule="stream")
    (region,) = lower_to_dataflow(p, plan, grid).regions
    call = StreamCall(p, region, grid, tile=tile, chunk=chunk)
    padded, svec, pc = _stream_inputs(p, call, grid, torch.float32, seed=9)
    want = stream_call_reference(call, padded, svec, pc)
    for queued in (False, True):
        got = run_stream_emulated(call, padded, svec, pc, queued=queued)
        torch.testing.assert_close(got["o"], want["o"], atol=1e-6,
                                   rtol=1e-6)


def test_generated_sweep_kernel_reads_windows_inside_an_oversized_carry():
    """``input_pad`` with a chain: the windows are read through a base
    offset and the carry's strides, and a shard origin moves the masks."""
    p, (call,) = _stream_calls(pw_advection, "zero", (7, 6, 40),
                               time_tile=2, tile=(4, 32), chunk=3)
    padded, svec, pc = _stream_inputs(p, call, (7, 6, 40), torch.float32,
                                      seed=4, scale=0.1)
    extra = np.array([[1, 2], [3, 1], [2, 2]])
    fpad = {k: np.stack([np.array(call.pad_lo), np.array(call.pad_hi)], 1)
            + extra for k in call.group_inputs}
    carry = {k: torch.nn.functional.pad(
        padded[k], (2, 2, 3, 1, 1, 2)).contiguous()
        for k in call.group_inputs}
    want = stream_call_reference(call, padded, svec, pc)
    for queued in (False, True):
        got = run_stream_emulated(call, carry, svec, pc, input_pad=fpad,
                                  queued=queued)
        for f in want:
            torch.testing.assert_close(got[f], want[f], atol=0, rtol=0)


def _unfused_chain_program():
    """A chainable region whose update rule runs in a loop of its own:
    output ``a`` has margins (``o`` reads it at offsets along axis 2), so
    the rule reads both outputs from their planes."""
    b = ProgramBuilder("chain_unfused", ndim=3)
    u = b.input("u")
    a = b.output("a")
    o = b.output("o")
    b.define(a, u[0, 0, -1] + u[0, 1, 0] * 0.5 - u[-1, 0, 0])
    b.define(o, a[0, 0, 1] - a[0, 0, -1] + u[1, 0, 0] * 0.25)
    return b.build()


@pytest.mark.parametrize("time_tile,tile,chunk", [(2, None, None),
                                                  (4, (4, 32), 3)])
def test_generated_sweep_kernel_chain_with_the_update_in_its_own_loop(
        time_tile, tile, chunk):
    """A chain whose update cannot run in its outputs' loop, against the
    plain version, with copies landing at once and at their wait; exact
    (the host build does not contract into FMAs)."""
    p = _unfused_chain_program()
    grid = (7, 6, 40)
    plan = auto_plan(p, grid, schedule="stream", time_tile=time_tile)
    (region,) = lower_to_dataflow(p, plan, grid).regions
    upd = adapt_update(lambda fields, out: {
        "u": fields["u"] + 0.1 * out["o"] - 0.05 * out["a"]})
    exprs, why = trace_update(p, upd, region.halo.group_inputs, ["a", "o"])
    assert why is None, why
    call = StreamCall(p, region, grid, time_tile=time_tile, update=upd,
                      update_exprs=exprs, tile=tile, chunk=chunk)
    src = call.source()
    assert src.count("// the update rule at this point") == 0
    padded, svec, pc = _stream_inputs(p, call, grid, torch.float32, seed=5,
                                      scale=0.1)
    want = stream_call_reference(call, padded, svec, pc)
    for queued in (False, True):
        got = run_stream_emulated(call, padded, svec, pc, queued=queued)
        for f in want:
            torch.testing.assert_close(got[f], want[f], atol=0, rtol=0)


# --------------------------------------------------------------------------
# A batch of requests in one launch
# --------------------------------------------------------------------------

def _batch_of_three(call, one_element, extents):
    """Three elements' kernel arguments stacked on a leading axis, each
    from ``one_element(k) -> (padded, svec, pcoeffs)`` with its own
    fields, coefficients and scalars (scalar rows scaled per element); a
    serving program's size scalars are ``extents(k)``."""
    els = [one_element(k) for k in range(3)]
    padded = {f: torch.stack([e[0][f] for e in els]) for f in els[0][0]}
    rows = [[v * (1.0 + 0.25 * k) for v in e[1]] for k, e in enumerate(els)]
    if call.domain is not None:
        rows = [r + list(extents(k)) for k, r in enumerate(rows)]
    sv = torch.tensor(rows, dtype=torch.float32)
    pc = {c: torch.stack([e[2][c] for e in els]) for c in els[0][2]}
    return padded, sv, pc


def _check_batch(call, run, batch, tol):
    """The batched launch bit-equal to three launches of one element, and
    within ``tol`` (relative to each field's max abs) of the batched plain
    version."""
    padded, sv, pc = batch
    got = run(call, padded, sv, pc)
    ref = (stream_call_reference if isinstance(call, StreamCall)
           else stencil3d.group_call_reference)
    want = ref(call, padded, sv, pc)
    for b in range(3):
        one = run(call, {f: x[b] for f, x in padded.items()}, sv[b],
                  {c: t[b] for c, t in pc.items()})
        for f in want:
            assert got[f].shape == (3,) + call.grid_shape, f
            assert torch.equal(got[f][b], one[f]), (b, f)
    for f in want:
        w, g = want[f].float(), got[f].float()
        assert torch.isfinite(g).all(), f
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()), f


def _serving_tracer():
    """tracer_advection with the serving layer's size scalars: every
    zero-boundary op is masked to each element's own real domain."""
    from repro_torch.serve import serving_program

    return serving_program(tracer_advection())


@pytest.mark.parametrize("case", ["pw_zero", "pw_periodic_bf16",
                                  "tracer_chunks", "tracer_serving"])
def test_generated_kernel_runs_a_batch_of_three(case):
    """The block kernel at B = 3, each element with its own fields,
    coefficients and scalars (a serving program: its own real extents
    too): bit-equal to three B = 1 launches of the same source, and equal
    to the batched plain version (pw exactly, tracer to 1e-5, as in
    :func:`test_generated_kernel_matches_plain_version`)."""
    p, dtype, block, tol = {
        "pw_zero": (pw_advection(), torch.float32, (2, 4, 32), 0.0),
        "pw_periodic_bf16": (pw_advection("periodic"), torch.bfloat16,
                             (2, 4, 32), 0.0),
        "tracer_chunks": (tracer_advection(), torch.float32, (4, 4, 32),
                          1e-5),
        "tracer_serving": (_serving_tracer(), torch.float32, (4, 4, 32),
                           1e-5),
    }[case]
    grid = (11, 6, 40)
    call = stencil3d.build_group_call(p, auto_plan(p, grid).groups[0], block,
                                      grid, dtype=dtype)

    def element(k):
        f, svec, c = _inputs(p, grid, dtype, seed=20 + k)
        padded, pc = _pad_all(p, call, f, c)
        return padded, svec[:2], pc

    # real domains [4, 4 + n) inside the grid, cut on both sides of each axis
    batch = _batch_of_three(call, element,
                            lambda k: (3 + k, 1 + k, 30 - 3 * k))
    _check_batch(call, lambda c, x, s, q: run_emulated(c, x, s, q), batch,
                 tol)


@pytest.mark.parametrize("queued", [False, True])
@pytest.mark.parametrize("case", ["pw_chunks", "pw_chain", "tracer",
                                  "tracer_serving"])
def test_generated_sweep_kernel_runs_a_batch_of_three(case, queued):
    """The sweep kernel at B = 3 (every region; a T=2 chain; a serving
    program with its own real extents an element), each element with its
    own fields, coefficients and scalars, with copies landing at once and
    queued by their thread: bit-equal to three B = 1 launches, and equal
    to the batched plain version (pw exactly, tracer to 1e-6, as in
    :func:`test_generated_sweep_kernel_matches_plain_version`)."""
    grid = (7, 6, 40)
    if case == "tracer_serving":
        p = _serving_tracer()
        plan = auto_plan(p, grid, schedule="stream")
        calls = [StreamCall(p, r, grid, tile=(2, 32), chunk=3)
                 for r in lower_to_dataflow(p, plan, grid).regions]
    else:
        app, kw = {"pw_chunks": (pw_advection, dict(tile=(2, 32), chunk=3)),
                   "pw_chain": (pw_advection, dict(time_tile=2)),
                   "tracer": (tracer_advection, {})}[case]
        p, calls = _stream_calls(app, "zero", grid, **kw)
    tol = 0.0 if p.name == "pw_advection" else 1e-6
    for call in calls:
        def element(k, call=call):
            return _stream_inputs(p, call, grid, torch.float32, seed=30 + k,
                                  scale=0.1)

        batch = _batch_of_three(call, element,
                                lambda k: (2 + k, 1 + k, 30 - 3 * k))
        _check_batch(call, lambda c, x, s, q: run_stream_emulated(
            c, x, s, q, queued=queued), batch, tol)
