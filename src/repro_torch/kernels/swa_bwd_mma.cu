// Backward of causal sliding-window attention for Hopper (sm_90a),
// bfloat16 on the tensor cores.  Built by repro_torch.kernels.swa, which
// defines SWA_T (__nv_bfloat16) and SWA_D (the head dim) ahead of this
// file; one library per head dim.  The float32 backward is swa_bwd.cu, on
// the CUDA cores.
//
// The TPU kernel swa_pallas (src/repro/kernels/swa.py:92) has no backward:
// the JAX model trains through its jnp swa_attention.  This is the gradient
// of swa_pallas's function, for training through swa_mma.cu under
// torch.autograd.  q: (B, S, H, D), k and v: (B, S, KV, D), the forward's
// output o and its cotangent dout: (B, S, H, D), all read through their
// strides (the head dim contiguous); query head h reads KV head h / G,
// G = H / KV.  lse: (B, H, S) float32, the forward's log-sum-exp of each
// row's scaled scores (swa_mma.cu stores it), so with s_ij = scale q_i.k_j
// on the band j in (i - window, i]:
//
//   P_ij = exp(s_ij - lse_i)
//   D_i  = dout_i . o_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dq_i = scale sum_j dS_ij k_j
//   dk_j = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dout_i
//
// (dk and dv summed over the G query heads of the KV head.)  dq, dk, dv are
// contiguous bf16; every sum is float32.
//
// Bound on the H100: operations.  The gradient takes five products over the
// band, 10 D operations a (query, key) pair; at one H2O-Danube layer (B 1,
// S 8192, H 32, D 80, w 4096) the band holds 8.05e8 pairs, 6.4e11
// operations, 0.65 ms at the tensor cores' 989 TFLOP/s, against 0.06 ms
// for the bytes.  This design does 14 D a pair: 6 D in swa_bwd_mma_dq (S,
// dP, dQ) and 8 D in swa_bwd_mma_dkdv (S^T, dP^T, dV, dK).  Recomputing S
// and dP in both kernels is the price of having no atomics: dq is owned by
// its query tile, dk and dv by their key tile, and the result does not
// depend on the order blocks run in (a resumed training run stays
// bit-equal).  Two exponentials a pair, one in each kernel; the forward's
// saved lse replaces the row-statistics pass that swa_bwd.cu makes.
//
// * swa_bwd_mma_dq: one CTA of 4 warps, 16 query rows a warp, per (64-row
//   query tile, head, batch row), heaviest tiles first.  Its prologue
//   computes D from one read of each dout and o row and stores it to
//   (B, H, S) for the second kernel.  K and V come in 64-key chunks
//   aligned to multiples of 64 through a 2-stage cp.async ring of bf16 rows
//   padded to DS (as swa_mma.cu).  S = Q K^T and dP = dout V^T by mma.sync
//   m16n8k16 (bf16 in, f32 sums; q's and dout's fragments in registers for
//   D_PAD <= 80); P = exp2(s scale log2e - lse log2e) and dS = P (dP - D)
//   in registers, packed to bf16 as the A fragments of dQ += dS K (the
//   accumulator layout is the A layout), K's B fragments by
//   ldmatrix.trans.  Only the band's edge chunks are masked.
// * swa_bwd_mma_dkdv: one CTA of 4 warps, 16 keys a warp, per (64-key tile,
//   KV head, batch row), launched after swa_bwd_mma_dq on the same stream.
//   It loops over the G query heads and over the 64-row query chunks that
//   see the key tile, [j0, j0 + 64 + window - 1), each (head, chunk) of q
//   and dout through a 2-stage cp.async ring.  The transposed products come
//   directly: S^T = K Q^T and dP^T = V dout^T, so P^T and dS^T sit in
//   accumulator layout and become the A fragments of dV += P^T dout and
//   dK += dS^T Q, with dout's and q's B fragments by ldmatrix.trans.  dK
//   and dV live in registers for the whole loop; K's and V's A fragments
//   are re-read from shared memory each chunk (registers are the scarcer
//   resource).  The chunk's lse and D ride beside it in shared memory,
//   loaded a chunk ahead.
//
// Masked pairs get P = 0 exactly; query rows at or past S read lse = +inf,
// so their P is 0 without a test.  wgmma and TMA are later work, as for
// swa_mma.cu.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define BQ 64                        // query rows of a tile or chunk
#define BK 64                        // keys of a tile or chunk
#define NW 4                         // warps of a CTA, 16 rows each
#define NT (32 * NW)
#define D_PAD ((SWA_D + 15) / 16 * 16)
#define DS (D_PAD + 8)               // shared row stride, elements
#define KS (D_PAD / 16)              // k-steps over the head dim
#define ND (D_PAD / 8)               // n-tiles over the head dim
#define SEG ((SWA_D + 7) / 8)        // 16-byte segments of a row
#define PADC (D_PAD > SWA_D ? D_PAD - SWA_D : 1)  // zero columns (if any)
#define QG_IN_REGS (D_PAD <= 80)
#define KQ (QG_IN_REGS ? KS : 1)
#define TILE_ROWS (6 * 64)           // bf16 rows of shared memory a CTA
// six 64-row tiles, then two stages of 64 lse and 64 D floats (dkdv; dq
// keeps 64 D floats there)
#define SMEM_BYTES (TILE_ROWS * DS * 2 + 4 * 64 * 4)
#define LOG2E 1.4426950408889634f

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
// cp.async copies; otherwise element by element.
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

// the pad columns [SWA_D, D_PAD) of every shared tile are zero, once
__device__ __forceinline__ void zero_pad_columns(SWA_T* tiles) {
  if (D_PAD > SWA_D) {
    for (int i = threadIdx.x; i < TILE_ROWS * PADC; i += NT)
      tiles[(i / PADC) * DS + SWA_D + i % PADC] = __float2bfloat16_rn(0.0f);
  }
}

// A fragments (16 rows x 16 columns at k-step kk) of a warp's rows
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const SWA_T* rows,
                                       int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, rows + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
}

// acc[8][4] += A (16 x D) times the transpose of a 64-row tile (B
// fragments from its rows, as swa_mma.cu reads K): 16 x 64 products over
// the head dim.  A's fragments are a[kk] when IN_REGS, else read from
// arows each k-step.
template <bool IN_REGS, int NA>
__device__ __forceinline__ void rows_times_tile_t(
    float (&acc)[8][4], const uint32_t (&a)[NA][4], const SWA_T* arows,
    const SWA_T* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    if constexpr (IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = a[kk][e];
    } else {
      frag_a(af, arows, kk);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, tile + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * DS +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(acc[2 * jp], af, b0);
      mma_16816(acc[2 * jp + 1], af, b1);
    }
  }
}

// out[ND][4] += A (16 x 16: bf16 fragments a of k-step kk) times rows
// [16 kk, 16 kk + 16) of a 64-row tile (B fragments by ldmatrix.trans, as
// swa_mma.cu reads V)
__device__ __forceinline__ void frag_times_tile(float (&out)[ND][4],
                                                const uint32_t (&a)[4],
                                                const SWA_T* tile, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < ND / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b, tile + (kk * 16 + (lane & 15)) * DS +
                         (2 * np + (lane >> 4)) * 8);
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_16816(out[2 * np], a, b0);
    mma_16816(out[2 * np + 1], a, b1);
  }
}

// one 64-key chunk starting at key c for this warp's 16 query rows (the
// first at qrow): dQ += dS K.  lse2 and dd: rows g and g + 8's lse log2(e)
// and D.  MASK: the chunk holds a band edge.
template <bool MASK>
__device__ __forceinline__ void chunk_dq(
    const SWA_T* ks, const SWA_T* vs, const SWA_T* qw, const SWA_T* gw,
    const uint32_t (&qa)[KQ][4], const uint32_t (&ga)[KQ][4],
    float (&acc)[ND][4], const float (&lse2)[2], const float (&dd)[2], int c,
    int qrow, int S, int window, float sl2e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
  rows_times_tile_t<QG_IN_REGS>(s, qa, qw, ks);
  rows_times_tile_t<QG_IN_REGS>(dp, ga, gw, vs);
  // dS, k-step by k-step (keys 16 kk to 16 kk + 15, n-tiles 2 kk and
  // 2 kk + 1), packed to bf16 as the A fragments of dQ += dS K
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t da[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[j][e], sl2e, -lse2[r]));
        if (MASK) {
          const int key = c + 8 * j + 2 * t + (e & 1);
          const int row = qrow + g + 8 * r;
          if (!(key <= row && key > row - window && key < S)) p = 0.0f;
        }
        ds[e] = p * (dp[j][e] - dd[r]);
      }
      da[2 * jj] = pack_bf16(ds[0], ds[1]);
      da[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile(acc, da, ks, kk);
  }
}

__global__ void __launch_bounds__(NT) swa_bwd_mma_dq(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, const SWA_T* __restrict__ o,
    const SWA_T* __restrict__ dout, const float* __restrict__ lse,
    SWA_T* __restrict__ dq, float* __restrict__ d_out, int S, int H, int G,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh,
    long long gsb, long long gss, long long gsh, int window, float scale,
    int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SWA_T* qs = (SWA_T*)smem_raw;         // BQ x DS
  SWA_T* gs = qs + BQ * DS;             // BQ x DS: dout
  SWA_T* kring = gs + BQ * DS;          // 2 x BK x DS
  SWA_T* vring = kring + 2 * BK * DS;   // 2 x BK x DS
  float* d_row = (float*)(vring + 2 * BK * DS);  // BQ

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const SWA_T* qb = q + b * qsb + h * qsh;
  const SWA_T* gb = dout + b * gsb + h * gsh;
  const SWA_T* kb = k + b * ksb + kvh * ksh;
  const SWA_T* vb = v + b * vsb + kvh * vsh;
  const long long row0 = ((long long)b * H + h) * S;
  SWA_T* qw = qs + 16 * warp * DS;  // this warp's q rows
  SWA_T* gw = gs + 16 * warp * DS;  // and dout rows

  zero_pad_columns(qs);
  const int c_lo = q0 - window + 1 > 0 ? (q0 - window + 1) / BK * BK : 0;
  const int n_chunks = (q0 - c_lo) / BK + 1;
  stage(qs, qb, qss, q0, S, vec);
  stage(gs, gb, gss, q0, S, vec);
  stage(kring, kb, kss, c_lo, S, vec);
  stage(vring, vb, vss, c_lo, S, vec);
  cp_async_commit();

  {  // D = dout . o from one read of each row, two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int d0 = half * (SWA_D / 2), d1 = half ? SWA_D : SWA_D / 2;
    float acc = 0.0f;
    if (q0 + r < S) {
      const SWA_T* gr = gb + (long long)(q0 + r) * gss;
      const SWA_T* orow = o + b * osb + h * osh + (long long)(q0 + r) * oss;
      for (int d = d0; d < d1; ++d)
        acc += __bfloat162float(gr[d]) * __bfloat162float(orow[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_row[r] = acc;
      if (q0 + r < S) d_out[row0 + q0 + r] = acc;
    }
  }
  // rows g and g + 8 of this warp: lse log2(e) (+inf past S) and D
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    lse2[r] = qi < S ? lse[row0 + qi] * LOG2E : INFINITY;
  }

  uint32_t qa[KQ][4], ga[KQ][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float sl2e = scale * LOG2E;

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
    if (i == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) dd[r] = d_row[16 * warp + g + 8 * r];
      if constexpr (QG_IN_REGS) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          frag_a(qa[kk], qw, kk);
          frag_a(ga[kk], gw, kk);
        }
      }
    }
    const SWA_T* ks = kring + (i & 1) * BK * DS;
    const SWA_T* vs = vring + (i & 1) * BK * DS;
    if (c == q0 || c <= q0 + BQ - 1 - window)
      chunk_dq<true>(ks, vs, qw, gw, qa, ga, acc, lse2, dd, c,
                     q0 + 16 * warp, S, window, sl2e);
    else
      chunk_dq<false>(ks, vs, qw, gw, qa, ga, acc, lse2, dd, c,
                      q0 + 16 * warp, S, window, sl2e);
    __syncthreads();  // every warp is done with this stage
  }

  // scale dS K, through this warp's q rows to 16-byte stores
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(qw + g * DS + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(qw + (g + 8) * DS + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
  SWA_T* dqb = dq + ((long long)b * S * H + h) * SWA_D;
  for (int i = lane; i < 16 * SEG; i += 32) {
    const int r = i / SEG, c = (i % SEG) * 8, qi = q0 + 16 * warp + r;
    if (qi >= S) continue;
    SWA_T* dst = dqb + (long long)qi * H * SWA_D + c;
    if (SWA_D % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(qw + r * DS + c);
    } else {
      for (int e = 0; e < 8 && c + e < SWA_D; ++e) dst[e] = qw[r * DS + c + e];
    }
  }
}

// one 64-row query chunk starting at row i0 against this warp's 16 keys
// (the first at key): dV += P^T dout, dK += dS^T Q.  lse2 and dd: the
// chunk's 64 rows' lse log2(e) and D.  MASK: the chunk holds a band edge.
template <bool MASK>
__device__ __forceinline__ void chunk_dkdv(
    const SWA_T* kw, const SWA_T* vw, const SWA_T* qs, const SWA_T* gs,
    const float* lse2, const float* dd, float (&dk)[ND][4],
    float (&dv)[ND][4], int i0, int key, int S, int window, float sl2e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t none[1][4] = {};
  float s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
  rows_times_tile_t<false>(s, none, kw, qs);   // S^T = K Q^T
  rows_times_tile_t<false>(dp, none, vw, gs);  // dP^T = V dout^T
  // P^T and dS^T, k-step by k-step (query rows 16 kk to 16 kk + 15,
  // n-tiles 2 kk and 2 kk + 1), packed to bf16 as the A fragments of
  // dV += P^T dout and dK += dS^T Q
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4], da[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj, col = 8 * j + 2 * t;  // rows col, col + 1
      const float l[2] = {lse2[col], lse2[col + 1]};
      const float dr[2] = {dd[col], dd[col + 1]};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[j][e], sl2e, -l[e & 1]));
        if (MASK) {
          const int kj = key + g + 8 * (e >> 1), qi = i0 + col + (e & 1);
          if (!(kj <= qi && kj > qi - window && qi < S)) p[e] = 0.0f;
        }
        ds[e] = p[e] * (dp[j][e] - dr[e & 1]);
      }
      pa[2 * jj] = pack_bf16(p[0], p[1]);
      pa[2 * jj + 1] = pack_bf16(p[2], p[3]);
      da[2 * jj] = pack_bf16(ds[0], ds[1]);
      da[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile(dv, pa, gs, kk);
    frag_times_tile(dk, da, qs, kk);
  }
}

// a query chunk's lse log2(e) (+inf past S) and D, one row a thread
__device__ __forceinline__ void chunk_rows(float& l2, float& d,
                                           const float* lse,
                                           const float* d_in, long long row0,
                                           int i0, int S) {
  const int qi = i0 + threadIdx.x;
  l2 = qi < S ? lse[row0 + qi] * LOG2E : INFINITY;
  d = qi < S ? d_in[row0 + qi] : 0.0f;
}

__global__ void __launch_bounds__(NT) swa_bwd_mma_dkdv(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, const SWA_T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ d_in,
    SWA_T* __restrict__ dk, SWA_T* __restrict__ dv, int S, int H, int G,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long gsb, long long gss, long long gsh, int window,
    float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SWA_T* ks = (SWA_T*)smem_raw;         // BK x DS
  SWA_T* vs = ks + BK * DS;             // BK x DS
  SWA_T* qring = vs + BK * DS;          // 2 x BQ x DS
  SWA_T* gring = qring + 2 * BQ * DS;   // 2 x BQ x DS: dout
  float* lring = (float*)(gring + 2 * BQ * DS);  // 2 x BQ: lse log2(e)
  float* dring = lring + 2 * BQ;                 // 2 x BQ: D

  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * BK;  // the first tiles see the most rows
  const int kvh = blockIdx.y, b = blockIdx.z, KV = H / G;
  const SWA_T* kw = ks + 16 * warp * DS;  // this warp's keys
  const SWA_T* vw = vs + 16 * warp * DS;

  zero_pad_columns(ks);
  // query chunks [j0, i_last] of each of the G heads, (head, chunk) pairs
  // in order through the ring
  const int j_last = min(j0 + BK, S) - 1;
  const int i_last = min(S - 1, j_last + window - 1);
  const int n_chunks = (i_last - j0) / BQ + 1, n_it = G * n_chunks;
  stage(ks, k + b * ksb + kvh * ksh, kss, j0, S, vec);
  stage(vs, v + b * vsb + kvh * vsh, vss, j0, S, vec);
  {
    const int h = kvh * G;
    stage(qring, q + b * qsb + h * qsh, qss, j0, S, vec);
    stage(gring, dout + b * gsb + h * gsh, gss, j0, S, vec);
    if (threadIdx.x < BQ)
      chunk_rows(lring[threadIdx.x], dring[threadIdx.x], lse, d_in,
                 ((long long)b * H + h) * S, j0, S);
  }
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  const float sl2e = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int i0 = j0 + (it % n_chunks) * BQ;
    const int st = it & 1;
    float l2_next = 0.0f, d_next = 0.0f;
    if (it + 1 < n_it) {  // the next (head, chunk) into the other stage
      const int h = kvh * G + (it + 1) / n_chunks;
      const int i1 = j0 + ((it + 1) % n_chunks) * BQ;
      stage(qring + (st ^ 1) * BQ * DS, q + b * qsb + h * qsh, qss, i1, S,
            vec);
      stage(gring + (st ^ 1) * BQ * DS, dout + b * gsb + h * gsh, gss, i1,
            S, vec);
      cp_async_commit();
      if (threadIdx.x < BQ)
        chunk_rows(l2_next, d_next, lse, d_in, ((long long)b * H + h) * S,
                   i1, S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const SWA_T* qs = qring + st * BQ * DS;
    const SWA_T* gs = gring + st * BQ * DS;
    const float* l2 = lring + st * BQ;
    const float* dd = dring + st * BQ;
    if (i0 == j0 || i0 + BQ - 1 - j0 >= window)
      chunk_dkdv<true>(kw, vw, qs, gs, l2, dd, dk_acc, dv_acc, i0,
                       j0 + 16 * warp, S, window, sl2e);
    else
      chunk_dkdv<false>(kw, vw, qs, gs, l2, dd, dk_acc, dv_acc, i0,
                        j0 + 16 * warp, S, window, sl2e);
    if (it + 1 < n_it && threadIdx.x < BQ) {
      // the other stage's rows were last read before this step's barrier
      lring[(st ^ 1) * BQ + threadIdx.x] = l2_next;
      dring[(st ^ 1) * BQ + threadIdx.x] = d_next;
    }
    __syncthreads();  // every warp is done with this stage
  }

  // scale dS^T Q and P^T dout, through this warp's K and V rows to 16-byte
  // stores (each warp reads only its own rows of ks and vs)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  SWA_T* kr = ks + 16 * warp * DS;
  SWA_T* vr = vs + 16 * warp * DS;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(kr + g * DS + 8 * n + 2 * t) =
        pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(kr + (g + 8) * DS + 8 * n + 2 * t) =
        pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    *reinterpret_cast<uint32_t*>(vr + g * DS + 8 * n + 2 * t) =
        pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(vr + (g + 8) * DS + 8 * n + 2 * t) =
        pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
  __syncwarp();
  const long long base = ((long long)b * S * KV + kvh) * SWA_D;
  for (int i = lane; i < 16 * SEG; i += 32) {
    const int r = i / SEG, c = (i % SEG) * 8, kj = j0 + 16 * warp + r;
    if (kj >= S) continue;
    const long long at = base + (long long)kj * KV * SWA_D + c;
    if (SWA_D % 8 == 0) {
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(kr + r * DS + c);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(vr + r * DS + c);
    } else {
      for (int e = 0; e < 8 && c + e < SWA_D; ++e) {
        dk[at + e] = kr[r * DS + c + e];
        dv[at + e] = vr[r * DS + c + e];
      }
    }
  }
}

// 16-byte copies need a head dim that is a multiple of 8, 16-byte aligned
// bases and row strides that are multiples of 8 elements
static int swa_bwd_vec(const void* q, const void* k, const void* v,
                       const void* dout, long long qsb, long long qss,
                       long long qsh, long long ksb, long long kss,
                       long long ksh, long long vsb, long long vss,
                       long long vsh, long long gsb, long long gss,
                       long long gsh) {
  const uintptr_t a =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  const long long s =
      qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh | gsb | gss | gsh;
  return SWA_D % 8 == 0 && a % 16 == 0 && s % 8 == 0;
}

extern "C" int swa_bwd_smem_bytes() { return SMEM_BYTES; }

extern "C" int swa_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* d, int B, int S, int H, int KV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss,
    long long gsh, int window, float scale, void* stream) {
  // the shared-memory attributes are a device's: set once on each device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(swa_bwd_mma_dq,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_bwd_mma_dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int G = H / KV;
  const int vec = swa_bwd_vec(q, k, v, dout, qsb, qss, qsh, ksb, kss, ksh,
                              vsb, vss, vsh, gsb, gss, gsh);
  const dim3 grid_dq((S + BQ - 1) / BQ, H, B);
  swa_bwd_mma_dq<<<grid_dq, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (const SWA_T*)o,
      (const SWA_T*)dout, (const float*)lse, (SWA_T*)dq, (float*)d, S, H, G,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb, gss,
      gsh, window, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dkdv((S + BK - 1) / BK, KV, B);
  swa_bwd_mma_dkdv<<<grid_dkdv, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (const SWA_T*)dout,
      (const float*)lse, (const float*)d, (SWA_T*)dk, (SWA_T*)dv, S, H, G,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, gsb, gss, gsh, window,
      scale, vec);
  return (int)cudaGetLastError();
}
