"""The port's sliding-window attention against the JAX package, on the CPU.

* the plain version ``swa_plain`` against the reference's Pallas kernel
  (``repro.kernels.ops.sliding_window_attention``, interpret mode) and its
  dense oracle ``swa_reference``, at ``tests/test_kernels.py``'s shapes plus
  D = 80 and a window >= S;
* the port's ``layers.swa_attention`` and ``ops.sliding_window_attention``
  against the reference's ``layers.swa_attention``;
* the CUDA sources run through the host C++ compiler with the CUDA shim of
  ``test_torch_kernel_emulated.py``, against ``swa_plain``: ``swa.cu``
  (float32) as it is, and ``swa_mma.cu`` (bfloat16, tensor cores) with its
  six PTX helpers (``ldmatrix``, ``ldmatrix.trans``, ``mma.sync``,
  ``cp.async`` and its commit and wait) replaced by host versions that
  exchange each lane's fragment registers through a per-warp buffer, as
  the PTX ISA lays them out.

Inputs are made from a numpy seed and handed to both packages.  Every
tolerance is relative to the compared tensor's own max abs: 2e-5 in
float32 (sums in another order), 2e-2 in bfloat16 (a few ulps of the
rounded output).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import sliding_window_attention as ref_swa_op
from repro.kernels.ref import swa_reference as ref_swa_reference
from repro.models.layers import AttnSpec as RefAttnSpec
from repro.models.layers import swa_attention as ref_swa_attention
from repro_torch.kernels import ops, swa
from repro_torch.kernels.ref import swa_reference
from repro_torch.models.layers import AttnSpec, swa_attention

from test_torch_kernel_emulated import SHIM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _qkv(B, S, H, KV, D, seed, dtype="float32"):
    """numpy float32 q (B,S,H,D), k and v (B,S,KV,D), rounded to ``dtype``
    (so both packages start from the same values), and torch twins."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, KV, KV)]
    tdt = getattr(torch, dtype)
    ts = [torch.as_tensor(a).to(tdt) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


# (B, S, H, KV, D, window, q_block): test_kernels.py's grid and GQA case,
# Danube's head dim, and a window that covers the whole sequence
CASES = [
    (2, 256, 4, 4, 64, 64, 128),
    (2, 256, 4, 4, 64, 128, 64),
    (2, 512, 4, 4, 64, 256, 128),
    (2, 128, 4, 4, 64, 32, 128),
    (2, 256, 8, 2, 64, 64, 128),
    (1, 256, 4, 2, 80, 96, 128),
    (1, 128, 4, 4, 64, 512, 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,w,bq", CASES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, KV, D, w, bq, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=S + w + D, dtype=dtype)
    got = swa.swa_plain(tq, tk, tv, window=w, q_block=bq)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = ref_swa_op(jq, jk, jv, window=w, q_block=bq)
    assert _rel(got.float(), pallas.astype(jnp.float32)) <= TOL[dtype]
    G = H // KV
    oracle = ref_swa_reference(jq, jnp.repeat(jk, G, 2), jnp.repeat(jv, G, 2),
                               window=w)
    assert _rel(got.float(), oracle.astype(jnp.float32)) <= TOL[dtype]
    # the port's oracle is the reference's
    mine = swa_reference(tq, tk.repeat_interleave(G, 2),
                         tv.repeat_interleave(G, 2), window=w)
    assert _rel(mine.float(), oracle.astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("H,KV,D,w", [(4, 4, 64, 64), (8, 2, 80, 100)])
def test_model_swa_path_matches_reference(H, KV, D, w):
    """The port's ``swa_attention`` against the reference's, and the
    kernel's wrapper (its plain version on the CPU) against it, as
    ``test_kernels.py::test_swa_matches_model_layer_path`` holds the
    Pallas kernel (float32)."""
    B, S = 2, 256
    (q, k, v), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=3)
    want = ref_swa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        RefAttnSpec(n_heads=H, n_kv_heads=KV, d_head=D, window=w, chunk=256))
    spec = AttnSpec(n_heads=H, n_kv_heads=KV, d_head=D, window=w, chunk=256)
    assert _rel(swa_attention(tq, tk, tv, spec), want) <= 2e-5
    assert _rel(ops.sliding_window_attention(tq, tk, tv, window=w),
                want) <= 2e-5


def test_plain_version_rejects_what_swa_pallas_rejects():
    _, (tq, tk, tv) = _qkv(1, 96, 2, 2, 16, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        swa.swa_plain(tq, tk, tv, window=8, q_block=64)
    with pytest.raises(ValueError, match="KV heads must divide"):
        swa.swa_plain(tq, tk[:, :, :1].repeat(1, 1, 3, 1),
                      tv[:, :, :1].repeat(1, 1, 3, 1), window=8)
    with pytest.raises(ValueError, match="window"):
        swa.swa_plain(tq, tk, tv, window=0)


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The launcher raises on CPU tensors (no fallback); its dispatcher
    sends them to the plain version."""
    _, (tq, tk, tv) = _qkv(1, 64, 2, 2, 16, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa.swa_cuda(tq, tk, tv, window=8)
    torch.testing.assert_close(ops.sliding_window_attention(tq, tk, tv,
                                                            window=8),
                               swa.swa_plain(tq, tk, tv, window=8))


def test_kernel_source_is_specialised_per_dtype_and_head_dim():
    """Each dtype has its source (float32 ``swa.cu``, bfloat16
    ``swa_mma.cu``) with the storage type and head dim defined ahead, and
    its own shared memory against the 232,448 B a CTA can use."""
    src = swa.kernel_source(torch.bfloat16, 80)
    assert src.startswith("#define SWA_T __nv_bfloat16\n#define SWA_D 80\n")
    assert src.endswith(swa.SOURCES[torch.bfloat16].read_text())
    assert "mma.sync" in src and "swa_kernel_mma" in src
    src = swa.kernel_source(torch.float32, 80)
    assert src.startswith("#define SWA_T float\n#define SWA_D 80\n")
    assert src.endswith(swa.SOURCES[torch.float32].read_text())
    assert "mma.sync" not in src
    assert swa.smem_bytes(torch.float32, 256) <= 232_448 \
        < swa.smem_bytes(torch.float32, 288)
    # bf16: (64 + 4 x 64) rows of D rounded up to 16, plus 8
    assert swa.smem_bytes(torch.bfloat16, 80) == 320 * 88 * 2
    assert swa.smem_bytes(torch.bfloat16, 40) == 320 * 56 * 2
    assert swa.smem_bytes(torch.bfloat16, 352) <= 232_448 \
        < swa.smem_bytes(torch.bfloat16, 353)
    with pytest.raises(ValueError, match="shared memory"):
        swa.kernel_source(torch.float32, 288)
    with pytest.raises(ValueError, match="shared memory"):
        swa.kernel_source(torch.bfloat16, 368)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        swa.kernel_source(torch.float64, 64)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        swa.smem_bytes(torch.float16, 64)


HELPERS = ("ldsm_x4", "ldsm_x4_trans", "mma_16816", "cp_async_16",
           "cp_async_commit", "cp_async_wait")
HELPERS_BEGIN, HELPERS_END = "// ---- PTX helpers", "// ---- end of PTX helpers"


def _split_helpers(src: str):
    """(before, the PTX helpers block, after) of ``swa_mma.cu``'s source."""
    head, rest = src.split(HELPERS_BEGIN)
    helpers, tail = rest.split(HELPERS_END)
    return head, helpers, tail


def test_mma_source_keeps_its_assembly_in_six_helpers():
    """All inline PTX of the bf16 kernel sits in the six helpers that the
    host emulation replaces, so the rest of the source runs unchanged."""
    head, helpers, tail = _split_helpers(swa.kernel_source(torch.bfloat16,
                                                           80))
    assert sorted(re.findall(r"void (\w+)\(", helpers)) == sorted(HELPERS)
    assert "asm" in helpers and "asm" not in head + tail
    for op in ("ldmatrix.sync.aligned.m8n8.x4.shared.b16",
               "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
               "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
               "cp.async.cg.shared.global", "cp.async.commit_group",
               "cp.async.wait_group"):
        assert op in helpers


# --------------------------------------------------------------------------
# the CUDA sources on the host
# --------------------------------------------------------------------------

# Host versions of what ``swa_mma.cu`` takes from CUDA beyond the shim:
# bf16 pairs, ``uint4``, ``gridDim``, ``__syncwarp``, ``__shfl_xor_sync``, and
# its six PTX helpers.  Each warp's 32 lanes are host threads that share an
# exchange buffer and a 32-thread barrier: a lane writes its registers (or
# its row address), all wait, each reads what the PTX ISA's fragment layout
# gives it, all wait again.
MMA_SHIM = r"""
#include <memory>
struct uint4 { unsigned x, y, z, w; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
thread_local dim3 gridDim;
struct emu_warp_t {
  std::barrier<> bar{32};
  const void* ptr[32];
  uint32_t reg[32][6];
  float f[32];
};
thread_local emu_warp_t* emu_warp;
inline int emu_lane() { return threadIdx.x % 32; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp->bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu_warp_t& w = *emu_warp;
  const int l = emu_lane();
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ m];
  w.bar.arrive_and_wait();
  return r;
}
// ldmatrix .x4: lanes 8i..8i+7 give the row addresses of 8x8 matrix i;
// lane l = 4g + t receives, in register i, row g, columns 2t and 2t+1 of
// matrix i (.trans: rows 2t and 2t+1 of column g), the lower in the low half
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  emu_warp_t& w = *emu_warp;
  const int l = emu_lane(), g = l / 4, t = l % 4;
  w.ptr[l] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (trans) {
      lo = ((const uint16_t*)w.ptr[8 * i + 2 * t])[g];
      hi = ((const uint16_t*)w.ptr[8 * i + 2 * t + 1])[g];
    } else {
      lo = ((const uint16_t*)w.ptr[8 * i + g])[2 * t];
      hi = ((const uint16_t*)w.ptr[8 * i + g])[2 * t + 1];
    }
    r[i] = lo | (uint32_t)hi << 16;
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  emu_ldsm(r, p, true); }
inline float emu_bf16(uint32_t reg, int half) {
  const uint32_t u = (half ? reg >> 16 : reg & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// mma m16n8k16 .row.col, lane l = 4g + t: A (16x16) rows g and g+8 in
// a0/a2 and a1/a3, columns 2t..2t+1 in a0/a1 and 2t+8..2t+9 in a2/a3; B
// (16x8) column g, rows 2t..2t+1 in b0 and 2t+8..2t+9 in b1; C and D
// (16x8) rows g (d0, d1) and g+8 (d2, d3), columns 2t and 2t+1
inline void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                      const uint32_t (&b)[2]) {
  emu_warp_t& w = *emu_warp;
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) w.reg[l][i] = a[i];
  w.reg[l][4] = b[0];
  w.reg[l][5] = b[1];
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) {
    const int row = l / 4 + 8 * (e / 2), col = 2 * (l % 4) + e % 2;
    float acc = 0.0f;
    for (int kk = 0; kk < 16; ++kk)
      acc += emu_bf16(w.reg[4 * (row % 8) + (kk % 8) / 2]
                           [row / 8 + 2 * (kk / 8)], kk % 2)
           * emu_bf16(w.reg[4 * col + (kk % 8) / 2][4 + kk / 8], kk % 2);
    d[e] += acc;
  }
  w.bar.arrive_and_wait();
}
inline void cp_async_16(void* dst, const void* src, bool full) {
  if (full) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
"""

# the emulated entries: every CTA's threads as host threads, one CTA at a
# time, launched with the arguments ``swa_launch`` takes (less the stream)
_EMU_ARGS = """const void* q, const void* k, const void* v, void* o, int B,
    int S, int H, int KV, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int window, float scale"""
F32_LAUNCH = r"""
extern "C" int emu_launch(ARGS) {
  const int smem = SMEM_FLOATS * sizeof(float);
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int t = 0; t < (S + BQ - 1) / BQ; ++t) {
        std::vector<unsigned char> sm(smem);
        std::barrier<> bar(NT);
        std::vector<std::thread> ts;
        for (int x = 0; x < NT; ++x)
          ts.emplace_back([&, x] {
            threadIdx = dim3(x); blockIdx = dim3(t, h, b);
            blockDim = dim3(NT); emu_bar = &bar; emu_smem = sm.data();
            swa_kernel((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
                       (SWA_T*)o, S, H, H / KV, qsb, qss, qsh, ksb, kss, ksh,
                       vsb, vss, vsh, window, scale);
          });
        for (auto& th : ts) th.join();
      }
  return 0;
}
extern "C" int emu_smem_bytes() { return SMEM_FLOATS * sizeof(float); }
""".replace("ARGS", _EMU_ARGS)
# shared memory starts as 0xff bytes (bf16 NaNs), so a read of anything
# the kernel did not stage or zero shows in the output
MMA_LAUNCH = r"""
extern "C" int emu_launch(ARGS) {
  const int vec = swa_vec(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                          vsh);
  const int tiles = (S + BQ - 1) / BQ;
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int t = 0; t < tiles; ++t) {
        std::vector<unsigned char> sm(SMEM_BYTES, 0xff);
        std::barrier<> bar(NT);
        std::unique_ptr<emu_warp_t[]> warps(new emu_warp_t[NW]);
        std::vector<std::thread> ts;
        for (int x = 0; x < NT; ++x)
          ts.emplace_back([&, x] {
            threadIdx = dim3(x); blockIdx = dim3(t, h, b);
            blockDim = dim3(NT); gridDim = dim3(tiles, H, B);
            emu_bar = &bar; emu_smem = sm.data(); emu_warp = &warps[x / 32];
            swa_kernel_mma((const SWA_T*)q, (const SWA_T*)k,
                           (const SWA_T*)v, (SWA_T*)o, S, H, H / KV, qsb, qss,
                           qsh, ksb, kss, ksh, vsb, vss, vsh, window, scale,
                           vec);
          });
        for (auto& th : ts) th.join();
      }
  return 0;
}
extern "C" int emu_smem_bytes() { return SMEM_BYTES; }
""".replace("ARGS", _EMU_ARGS)


def _host_library(src: str, shim: str, name: str) -> ctypes.CDLL:
    """``src`` compiled by the host C++ compiler with ``shim`` included
    first, cached by the hash of both."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel source")
    tag = hashlib.sha256((shim + "\0" + src).encode()).hexdigest()[:16]
    d_ = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "repro_torch_emu")
    os.makedirs(os.path.join(d_, "inc"), exist_ok=True)
    for h in ("cuda_runtime.h", "cuda_bf16.h"):
        open(os.path.join(d_, "inc", h), "w").close()
    so = os.path.join(d_, f"{name}_{tag}.so")
    if not os.path.exists(so):
        hdr = os.path.join(d_, f"{name}_{tag}.{os.getpid()}.h")
        with open(hdr, "w") as fh:
            fh.write(shim)
        cc = os.path.join(d_, f"{name}_{tag}.{os.getpid()}.cc")
        with open(cc, "w") as fh:
            fh.write(src)
        tmp = so + f".{os.getpid()}"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-fno-strict-aliasing", "-include", hdr,
                        "-I", os.path.join(d_, "inc"), "-o", tmp, cc], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def _emulated(dtype: torch.dtype, d: int):
    """ctypes entry running the dtype's kernel source on host threads:
    every CTA's threads as host threads, ``__syncthreads`` a barrier; for
    ``swa_mma.cu``, its PTX helpers block taken out and ``MMA_SHIM``'s host
    versions in its place."""
    src = swa.kernel_source(dtype, d)
    mma = dtype == torch.bfloat16
    if mma:
        head, _, tail = _split_helpers(src)
        src = head + tail
    src = src.split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    src += MMA_LAUNCH if mma else F32_LAUNCH
    lib = _host_library(src, SHIM + (MMA_SHIM if mma else ""), "swa")
    # the launcher's shared-memory check and the kernel agree on the size
    assert lib.emu_smem_bytes() == swa.smem_bytes(dtype, d)
    fn = lib.emu_launch
    fn.argtypes = swa._ARGTYPES[:-1]
    fn.restype = ctypes.c_int
    return fn


def run_emulated(q, k, v, window):
    """The kernel launched as ``swa.swa_cuda`` launches it (same argument
    marshalling), on CPU tensors, through the emulated entry."""
    B, S, H, D = q.shape
    o = torch.full((B, S, H, D), float("nan"), dtype=q.dtype)
    _emulated(q.dtype, D)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, S, H, k.shape[2], *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], int(window),
                          1.0 / np.sqrt(D))
    return o


FRAG_HARNESS = r"""
// one warp: A (16x16) by ldmatrix as the kernel reads q, B (16x16, two
// n-tiles of 8) by ldmatrix from B^T's rows as the kernel reads K, and by
// ldmatrix.trans from B's rows as it reads V; A B by mma_16816 both ways
extern "C" void emu_frag(const uint16_t* a, const uint16_t* bt,
                         const uint16_t* b, float* dk, float* dv,
                         uint32_t* regs) {
  std::unique_ptr<emu_warp_t> w(new emu_warp_t);
  std::vector<std::thread> ts;
  for (int x = 0; x < 32; ++x)
    ts.emplace_back([&, x] {
      threadIdx = dim3(x); emu_warp = w.get();
      const int lane = x;
      uint32_t qa[4], kb[4], vb[4];
      ldsm_x4(qa, a + (lane & 15) * 16 + (lane >> 4) * 8);
      ldsm_x4(kb, bt + ((lane >> 4) * 8 + (lane & 7)) * 16
                     + ((lane >> 3) & 1) * 8);
      ldsm_x4_trans(vb, b + (lane & 15) * 16 + (lane >> 4) * 8);
      for (int n = 0; n < 2; ++n) {
        float ok[4] = {0, 0, 0, 0}, ov[4] = {0, 0, 0, 0};
        const uint32_t bk[2] = {kb[2 * n], kb[2 * n + 1]};
        const uint32_t bv[2] = {vb[2 * n], vb[2 * n + 1]};
        mma_16816(ok, qa, bk);
        mma_16816(ov, qa, bv);
        for (int e = 0; e < 4; ++e) {
          const int row = lane / 4 + 8 * (e / 2);
          const int col = 8 * n + 2 * (lane % 4) + e % 2;
          dk[row * 16 + col] = ok[e];
          dv[row * 16 + col] = ov[e];
        }
      }
      for (int i = 0; i < 4; ++i) {
        regs[lane * 12 + i] = qa[i];
        regs[lane * 12 + 4 + i] = kb[i];
        regs[lane * 12 + 8 + i] = vb[i];
      }
    });
  for (auto& th : ts) th.join();
}
"""


def test_emulated_fragments_match_the_isa_and_torch_matmul():
    """The host ``ldmatrix``/``ldmatrix.trans``/``mma_16816`` against the
    PTX ISA's fragment tables, lane by lane, and ``A @ B`` (16x16 by 16x8,
    both n-tiles of a 16x16 B) against ``torch.matmul``."""
    lib = _host_library(FRAG_HARNESS, SHIM + MMA_SHIM, "frag")
    rng = np.random.default_rng(7)
    a, b = (torch.as_tensor(rng.standard_normal((16, 16)).astype(
        np.float32)).bfloat16() for _ in range(2))
    bits = [x.contiguous().view(torch.int16).numpy().astype(np.uint16)
            for x in (a, b.t().contiguous(), b)]
    dk, dv = np.zeros((16, 16), np.float32), np.zeros((16, 16), np.float32)
    regs = np.zeros((32, 12), np.uint32)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.emu_frag.restype = None
    lib.emu_frag(*(ptr(x) for x in (*bits, dk, dv, regs)))

    A, B = bits[0], bits[2]
    pair = lambda lo, hi: int(lo) | int(hi) << 16  # noqa: E731
    for lane in range(32):
        g, t = divmod(lane, 4)
        # A: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+8), a3 (g+8, 2t+8)
        for i, (r, c) in enumerate([(g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8)]):
            assert regs[lane, i] == pair(A[r, c], A[r, c + 1])
        # B of n-tile n: b0 rows 2t..2t+1, b1 rows 2t+8..2t+9, column g
        for n in range(2):
            for j, r in enumerate((2 * t, 2 * t + 8)):
                want = pair(B[r, 8 * n + g], B[r + 1, 8 * n + g])
                assert regs[lane, 4 + 2 * n + j] == want
                assert regs[lane, 8 + 2 * n + j] == want
    want = torch.matmul(a.float(), b.float())
    for n in range(2):
        cols = slice(8 * n, 8 * n + 8)
        torch.testing.assert_close(torch.as_tensor(dk[:, cols]),
                                   torch.matmul(a.float(), b[:, cols].float()),
                                   rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(torch.as_tensor(dv), want, rtol=1e-6,
                               atol=1e-5)


# (B, S, H, KV, D, window, dtype).  float32 runs ``swa.cu``: Danube's GQA
# and head dim, a head dim that is not a multiple of 16, a ragged last tile
# with a window >= S, window 1.  bfloat16 runs ``swa_mma.cu``: Danube's
# head dim with GQA 4:1 and interior (mask-free) chunks; D 64 and a window
# that is not a multiple of 64 (also with two lower-edge chunks and
# interior ones); D 24 (pads to 32); D 256 (q re-read each chunk); a
# ragged last tile at D 40; window 1; a window >= S; D 20 (staged element
# by element).  q is always read through a transposed view.
EMU_CASES = [
    (1, 192, 4, 1, 80, 96, "float32"),
    (1, 160, 2, 2, 24, 40, "float32"),
    (2, 100, 2, 1, 32, 500, "float32"),
    (1, 128, 2, 2, 16, 1, "float32"),
    (1, 192, 2, 1, 64, 70, "bfloat16"),
    (1, 320, 4, 1, 80, 128, "bfloat16"),
    (1, 384, 2, 1, 64, 200, "bfloat16"),
    (1, 160, 2, 2, 24, 40, "bfloat16"),
    (1, 128, 2, 1, 256, 100, "bfloat16"),
    (1, 100, 2, 2, 40, 30, "bfloat16"),
    (1, 128, 2, 2, 16, 1, "bfloat16"),
    (2, 100, 2, 1, 32, 500, "bfloat16"),
    (1, 96, 2, 1, 20, 50, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,KV,D,w,dtype", EMU_CASES)
def test_kernel_source_matches_plain_version_on_the_host(B, S, H, KV, D, w,
                                                         dtype):
    """The dtype's source against ``swa_plain`` (f32: 2e-5 relative; bf16:
    2e-2, P rounded to bf16 for the second product and the outputs rounded
    from float32 sums in different orders).  q is read through strides that
    are not contiguous: a (B,H,S,D) buffer seen as (B,S,H,D), as a
    transpose would give it."""
    (_, _, _), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=D + w, dtype=dtype)
    tq = tq.transpose(1, 2).contiguous().transpose(1, 2)
    got = run_emulated(tq, tk, tv, w)
    bq = 64 if S % 64 == 0 else S
    want = swa.swa_plain(tq, tk, tv, window=w, q_block=bq)
    assert torch.isfinite(got.float()).all()
    assert _rel(got.float(), want.float()) <= TOL[dtype]
