// Causal sliding-window attention for Hopper (sm_90a), bfloat16 on the
// tensor cores.  Built by repro_torch.kernels.swa, which defines SWA_T
// (__nv_bfloat16) and SWA_D (the head dim) ahead of this file; one library
// per head dim.  The float32 instantiation is swa.cu, on the CUDA cores.
//
// Replaces the TPU kernel swa_pallas (src/repro/kernels/swa.py:92).
// q: (B, S, H, D), k and v: (B, S, KV, D), read through their strides (the
// head dim contiguous); query head h reads KV head h / (H / KV).  Query i
// attends to keys (i - window, i].  o: (B, S, H, D) contiguous, bf16; the
// softmax statistics and the sums are float32.
//
// Bound on the H100: operations.  4 D operations a (query, key) pair of the
// band: at H2O-Danube's prefill (B 2, S 8192, H 32, D 80, w 4096) 5.2e11,
// 0.52 ms at the tensor cores' 989 TFLOP/s, plus about 0.4 ms of exp2 on
// the SFUs (1.6e9 pairs at 16 a clock an SM); the bytes take 0.06 ms.
// The design keeps both products on the tensor cores and the exponentials
// at one FFMA and one ex2 a pair:
//
// * one CTA of 4 warps per (64-row query tile, head, batch row), 16 rows a
//   warp; the tiles run heaviest first (blockIdx.x reversed), so the short
//   tiles below q0 < window fill the tail;
// * the q tile is copied once by cp.async; K and V come in 64-key chunks
//   aligned to multiples of 64 through a 2-stage ring of 16-byte cp.async
//   copies, so chunk j + 1 loads while chunk j computes.  Everything stays
//   bf16 in shared memory, rows padded to DS = D_PAD + 8 elements (ldmatrix
//   free of bank conflicts), D_PAD = D rounded up to 16 with zero columns
//   that are never stored;
// * S = Q K^T and O += P V by mma.sync m16n8k16 (bf16 in, f32 sums).  Q's
//   fragments stay in registers for D_PAD <= 128 (re-read from shared memory
//   each chunk above), K's come by ldmatrix, V's by ldmatrix.trans.  The
//   score accumulators are packed to bf16 in registers as P's A fragments
//   (the m16n8k16 accumulator layout is the A layout), as FlashAttention
//   and the JAX model's swa_attention round P; l sums the f32 p;
// * the online softmax lives in registers: a thread holds parts of two
//   rows, the row max is taken across the quad by __shfl_xor_sync, exp2
//   has scale * log2(e) folded into one FFMA, and a row with no key yet
//   keeps m = -inf without a NaN;
// * only the band's edge chunks are masked: those below the window's lower
//   edge of the tile's last row, and the diagonal chunk (causal, and the
//   ragged end of the sequence).  The interior chunks (63 of Danube's 65 a
//   tile) run the mask-free body.
//
// wgmma, TMA and warp specialisation are later work: Danube's 160-byte rows
// are not a swizzle atom.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define BQ 64                        // query rows of a CTA
#define BK 64                        // keys of a chunk
#define NW 4                         // warps of a CTA, 16 query rows each
#define NT (32 * NW)
#define D_PAD ((SWA_D + 15) / 16 * 16)
#define DS (D_PAD + 8)               // shared row stride, elements
#define KS (D_PAD / 16)              // k-steps of Q K^T
#define ND (D_PAD / 8)               // n-tiles of O
#define SEG ((SWA_D + 7) / 8)        // 16-byte segments of a row
#define PADC (D_PAD > SWA_D ? D_PAD - SWA_D : 1)  // zero columns (if any)
#define Q_IN_REGS (D_PAD <= 128)
#define KQ (Q_IN_REGS ? KS : 1)
#define SMEM_BYTES ((BQ + 4 * BK) * DS * 2)  // q tile, 2 K and 2 V stages

// ---- PTX helpers: all of the kernel's inline assembly
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 16 bytes from global to shared memory; zeros where full is false
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
// ---- end of PTX helpers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of an (S, D) slab with row stride rs into a shared
// tile of stride DS; rows at or past S read as zeros.  vec: 16-byte
// cp.async copies; otherwise element by element (a head dim that is not a
// multiple of 8, or a base or stride that is not 16-byte aligned).
__device__ __forceinline__ void stage(SWA_T* dst, const SWA_T* src,
                                      long long rs, int r0, int S,
                                      bool vec) {
  for (int i = threadIdx.x; i < 64 * SEG; i += NT) {
    const int r = i / SEG, c = (i % SEG) * 8;
    const bool in = r0 + r < S;
    const SWA_T* s = src + (long long)(in ? r0 + r : 0) * rs + c;
    SWA_T* d = dst + r * DS + c;
    if (vec) {
      cp_async_16(d, s, in);
    } else {
      for (int e = 0; e < 8 && c + e < SWA_D; ++e)
        d[e] = in ? s[e] : __float2bfloat16_rn(0.0f);
    }
  }
}

// One 64-key chunk starting at key c for this warp's 16 rows (the first at
// qrow): scores, online softmax, O += P V.  MASK: the chunk holds a band
// edge, and each score is tested against (row - window, row] and S.
template <bool MASK>
__device__ __forceinline__ void chunk(const SWA_T* ks, const SWA_T* vs,
                                      const SWA_T* qw,
                                      const uint32_t (&qa)[KQ][4],
                                      float (&o)[ND][4], float (&m)[2],
                                      float (&l)[2], int c, int qrow, int S,
                                      int window, float sl2e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
    } else {
      ldsm_x4(a, qw + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * DS +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(s[2 * jp], a, b0);
      mma_16816(s[2 * jp + 1], a, b1);
    }
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c + 8 * j + 2 * t + (e & 1);
        const int row = qrow + g + 8 * (e >> 1);
        if (!(key <= row && key > row - window && key < S))
          s[j][e] = -INFINITY;
      }
  }

  // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    msc[r] = (mx[r] == -INFINITY ? 0.0f : mx[r]) * sl2e;
    const float corr = exp2f(m[r] * sl2e - msc[r]);  // 0 while empty
    m[r] = mx[r];
    l[r] *= corr;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * r] *= corr;
      o[n][2 * r + 1] *= corr;
    }
  }
  // P as the A fragments of P V: k-step kk covers n-tiles 2 kk and 2 kk + 1
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2f(fmaf(s[j][0], sl2e, -msc[0]));
    const float p1 = exp2f(fmaf(s[j][1], sl2e, -msc[0]));
    const float p2 = exp2f(fmaf(s[j][2], sl2e, -msc[1]));
    const float p3 = exp2f(fmaf(s[j][3], sl2e, -msc[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (kk * 16 + (lane & 15)) * DS +
                           (2 * np + (lane >> 4)) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(o[2 * np], pa[kk], b0);
      mma_16816(o[2 * np + 1], pa[kk], b1);
    }
}

__global__ void __launch_bounds__(NT) swa_kernel_mma(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, SWA_T* __restrict__ o, int S, int H, int G,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int window, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SWA_T* qs = (SWA_T*)smem_raw;         // BQ x DS
  SWA_T* kring = qs + BQ * DS;          // 2 x BK x DS
  SWA_T* vring = kring + 2 * BK * DS;   // 2 x BK x DS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const SWA_T* qb = q + b * qsb + h * qsh;
  const SWA_T* kb = k + b * ksb + kvh * ksh;
  const SWA_T* vb = v + b * vsb + kvh * vsh;
  SWA_T* qw = qs + 16 * warp * DS;  // this warp's q rows

  // the pad columns [SWA_D, D_PAD) of every tile are zero, once
  if (D_PAD > SWA_D) {
    for (int i = threadIdx.x; i < (BQ + 4 * BK) * PADC; i += NT)
      qs[(i / PADC) * DS + SWA_D + i % PADC] = __float2bfloat16_rn(0.0f);
  }
  // keys in 64-aligned chunks from the one holding q0 - window + 1 to the
  // diagonal one at q0
  const int c_lo = q0 - window + 1 > 0 ? (q0 - window + 1) / BK * BK : 0;
  const int n_chunks = (q0 - c_lo) / BK + 1;
  stage(qs, qb, qss, q0, S, vec);
  stage(kring, kb, kss, c_lo, S, vec);
  stage(vring, vb, vss, c_lo, S, vec);
  cp_async_commit();

  uint32_t qa[KQ][4];
  float acc[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float sl2e = scale * 1.4426950408889634f;

  for (int i = 0; i < n_chunks; ++i) {
    const int c = c_lo + i * BK;
    if (i + 1 < n_chunks) {  // the next chunk into the other stage
      const int st = (i + 1) & 1;
      stage(kring + st * BK * DS, kb, kss, c + BK, S, vec);
      stage(vring + st * BK * DS, vb, vss, c + BK, S, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qa[kk], qw + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
      }
    }
    const SWA_T* ks = kring + (i & 1) * BK * DS;
    const SWA_T* vs = vring + (i & 1) * BK * DS;
    // an edge chunk: its first key is at or below the tile's last row's
    // lower edge, or it is the diagonal chunk
    if (c == q0 || c <= q0 + BQ - 1 - window)
      chunk<true>(ks, vs, qw, qa, acc, m, l, c, q0 + 16 * warp, S, window,
                  sl2e);
    else
      chunk<false>(ks, vs, qw, qa, acc, m, l, c, q0 + 16 * warp, S, window,
                   sl2e);
    __syncthreads();  // every warp is done with this stage
  }

  // O / l, through this warp's q rows to 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(qw + g * DS + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(qw + (g + 8) * DS + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  SWA_T* ob = o + ((long long)b * S * H + h) * SWA_D;
  for (int i = lane; i < 16 * SEG; i += 32) {
    const int r = i / SEG, c = (i % SEG) * 8, qi = q0 + 16 * warp + r;
    if (qi >= S) continue;
    SWA_T* dst = ob + (long long)qi * H * SWA_D + c;
    if (SWA_D % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(qw + r * DS + c);
    } else {
      for (int e = 0; e < 8 && c + e < SWA_D; ++e) dst[e] = qw[r * DS + c + e];
    }
  }
}

// 16-byte copies need a head dim that is a multiple of 8, 16-byte aligned
// bases and row strides that are multiples of 8 elements
static int swa_vec(const void* q, const void* k, const void* v,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh) {
  const uintptr_t a = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const long long s = qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh;
  return SWA_D % 8 == 0 && a % 16 == 0 && s % 8 == 0;
}

extern "C" int swa_launch(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int KV, long long qsb,
                          long long qss, long long qsh, long long ksb,
                          long long kss, long long ksh, long long vsb,
                          long long vss, long long vsh, int window,
                          float scale, void* stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        swa_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_kernel_mma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_kernel_mma<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (SWA_T*)o, S, H,
      H / KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, window, scale,
      swa_vec(q, k, v, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh));
  return (int)cudaGetLastError();
}
