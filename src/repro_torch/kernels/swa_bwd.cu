// Backward of causal sliding-window attention for Hopper (sm_90a), on the
// CUDA cores in float32.  Built by repro_torch.kernels.swa, which defines
// SWA_T (float) and SWA_D (the head dim) ahead of this file; one library
// per head dim.  The bfloat16 backward is swa_bwd_mma.cu, on the tensor
// cores.
//
// The TPU kernel swa_pallas (src/repro/kernels/swa.py:92) has no backward:
// the JAX model trains through its jnp swa_attention.  This is the gradient
// of swa_pallas's function, for training through the forward kernels
// (swa_mma.cu, swa.cu) under torch.autograd.
//
// q: (B, S, H, D), k and v: (B, S, KV, D), the forward's output o and its
// cotangent dout: (B, S, H, D), all read through their strides (the head
// dim contiguous); query head h reads KV head h / G, G = H / KV.  With
// s_ij = scale q_i.k_j on the band j in (i - window, i]:
//
//   P_ij = exp(s_ij - m_i) / l_i   (m_i, l_i: the row's max and sum)
//   D_i  = dout_i . o_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dq_i = scale sum_j dS_ij k_j
//   dk_j = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dout_i
//
// (dk and dv summed over the G query heads of the KV head.)  dq, dk, dv are
// contiguous, in SWA_T; every sum is float32.
//
// Bound on the H100: operations.  The gradient takes five products over the
// band, 10 D operations a (query, key) pair; this design does 16 D (each
// kernel recomputes s and dout.v, swa_bwd_dq twice over).  For one
// H2O-Danube layer (B 1, S 8192, H 32, D 80, w 4096) the band holds 8.1e8
// pairs: 6.4e11 operations of the gradient, 0.65 ms at the tensor cores'
// 989 TFLOP/s, against 0.06 ms for the bytes.  A simple design first:
//
// * swa_bwd_dq: one CTA of 256 threads per (64-row query tile, head,
//   batch row).  q and dout tiles are staged in shared memory as float32.
//   Pass 1 walks the tile's key range in 64-key chunks for each row's max
//   and sum, the forward's online softmax, and stores m, l and D (float32,
//   (B, H, S)); pass 2 walks it again for dS, accumulating dq in registers
//   (a 4 x ceil(D/16) tile a thread, as swa.cu accumulates o).
// * swa_bwd_dkdv: one CTA per (64-key tile, KV head, batch row), launched
//   after swa_bwd_dq on the same stream.  For each of the G query heads it
//   walks the query rows that see the tile, [j0, j0 + 64 + window - 1), in
//   64-row chunks, recomputing P from m and l and dS from D, and
//   accumulates dk and dv in registers.  The GQA sum stays in the CTA: no
//   atomics, and the result does not depend on the order blocks run in.
//
// Masked pairs get P = 0 exactly, as the forward's exp(-inf); every row
// sees its own position, so l_i > 0.  TF32 products on the tensor cores
// would not meet float32's 1e-4, as for swa.cu.
#include <cuda_runtime.h>
#include <math.h>

#define BQ 64
#define BK 64
#define NT 256
#define DB ((SWA_D + 15) / 16)  // columns of D a thread owns
#define QS (SWA_D + 1)          // rows of D in shared memory (odd stride)
#define PS (BK + 1)             // rows of a 64 x 64 tile in shared memory
// q, dout, k and v tiles, the P/dS tile, then per-row statistics
#define DQ_SMEM_FLOATS (4 * BQ * QS + BQ * PS + 11 * BQ)
#define DKDV_SMEM_FLOATS (4 * BQ * QS + BK * PS + 3 * BQ)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// rows [r0, r0 + 64) of a (S, D) slice with row stride ss into shared
// memory as float32, zeros past S
__device__ __forceinline__ void stage(float* dst, const SWA_T* src,
                                      long long ss, int r0, int S,
                                      int tid) {
  for (int i = tid; i < 64 * SWA_D; i += NT) {
    const int r = i / SWA_D, d = i % SWA_D;
    dst[r * QS + d] = (r0 + r < S) ? ld(src + (long long)(r0 + r) * ss + d)
                                   : 0.0f;
  }
}

__global__ void __launch_bounds__(NT) swa_bwd_dq(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, const SWA_T* __restrict__ o,
    const SWA_T* __restrict__ dout, SWA_T* __restrict__ dq,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ d_out, int S, int H, int G, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long gsb,
    long long gss, long long gsh, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = (float*)smem_raw;      // BQ x QS
  float* gs = qs + BQ * QS;          // BQ x QS: dout
  float* ks = gs + BQ * QS;          // BK x QS
  float* vs = ks + BK * QS;          // BK x QS
  float* ps = vs + BK * QS;          // BQ x PS: scores, then dS
  float* rmax = ps + BQ * PS;        // BQ x 4 partial row maxima
  float* rsum = rmax + 4 * BQ;       // BQ x 4 partial row sums (and D)
  float* m_run = rsum + 4 * BQ;      // row max
  float* l_run = m_run + BQ;         // row sum
  float* d_row = l_run + BQ;         // D

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int sr = tid >> 2, sq = tid & 3;  // row statistics: row, quarter
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const SWA_T* qb = q + b * qsb + h * qsh;
  const SWA_T* kb = k + b * ksb + kvh * ksh;
  const SWA_T* vb = v + b * vsb + kvh * vsh;
  const SWA_T* ob = o + b * osb + h * osh;
  const SWA_T* gb = dout + b * gsb + h * gsh;

  stage(qs, qb, qss, q0, S, tid);
  stage(gs, gb, gss, q0, S, tid);
  if (tid < BQ) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  __syncthreads();
  {  // D = dout . o, four threads a row
    float acc = 0.0f;
    if (q0 + sr < S)
      for (int d = sq; d < SWA_D; d += 4)
        acc += gs[sr * QS + d] * ld(ob + (long long)(q0 + sr) * oss + d);
    rsum[4 * sr + sq] = acc;
  }
  __syncthreads();
  if (sq == 0)
    d_row[sr] = (rsum[4 * sr] + rsum[4 * sr + 1])
                + (rsum[4 * sr + 2] + rsum[4 * sr + 3]);

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_first = max(0, q0 - window + 1);

  // pass 1: each row's max and sum over the band
  for (int k0 = k_first; k0 <= q_last; k0 += BK) {
    __syncthreads();  // the last chunk's readers of ks, ps and rsum are done
    stage(ks, kb, kss, k0, S, tid);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    for (int d = 0; d < SWA_D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qv[a] * kv[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = q0 + ty + 16 * a, kj = k0 + tx + 16 * c;
        const bool ok = kj <= qi && kj > qi - window && kj < S;
        ps[(ty + 16 * a) * PS + tx + 16 * c] = ok ? s[a][c] * scale
                                                  : -INFINITY;
      }
    __syncthreads();
    float mx = -INFINITY;
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, ps[sr * PS + sq * 16 + j]);
    rmax[4 * sr + sq] = mx;
    __syncthreads();
    const float m_new = fmaxf(
        fmaxf(fmaxf(rmax[4 * sr], rmax[4 * sr + 1]),
              fmaxf(rmax[4 * sr + 2], rmax[4 * sr + 3])), m_run[sr]);
    const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
    float sum = 0.0f;
    for (int j = 0; j < 16; ++j) sum += expf(ps[sr * PS + sq * 16 + j] - m_use);
    rsum[4 * sr + sq] = sum;
    __syncthreads();
    if (sq == 0) {
      l_run[sr] = l_run[sr] * expf(m_run[sr] - m_use)
                  + ((rsum[4 * sr] + rsum[4 * sr + 1])
                     + (rsum[4 * sr + 2] + rsum[4 * sr + 3]));
      m_run[sr] = m_new;
    }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < S) {
    const long long i = ((long long)b * H + h) * S + q0 + tid;
    m_out[i] = m_run[tid];
    l_out[i] = l_run[tid];
    d_out[i] = d_row[tid];
  }

  // pass 2: dS, and dq = scale dS K
  float acc[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) acc[a][c] = 0.0f;
  for (int k0 = k_first; k0 <= q_last; k0 += BK) {
    __syncthreads();  // the last chunk's readers of ks, vs and ps are done
    stage(ks, kb, kss, k0, S, tid);
    stage(vs, vb, vss, k0, S, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
    for (int d = 0; d < SWA_D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = qs[(ty + 16 * a) * QS + d];
        gv[a] = gs[(ty + 16 * a) * QS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = ks[(tx + 16 * c) * QS + d];
        vv[c] = vs[(tx + 16 * c) * QS + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] += qv[a] * kv[c];
          dp[a][c] += gv[a] * vv[c];
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, qi = q0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool ok = qi < S && kj <= qi && kj > qi - window;
        const float p = ok ? expf(s[a][c] * scale - m_run[r]) / l_run[r]
                           : 0.0f;
        ps[r * PS + tx + 16 * c] = p * (dp[a][c] - d_row[r]);
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = ps[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) {
        const int d = tx + 16 * cc;
        if (SWA_D % 16 == 0 || d < SWA_D) {
          const float kk = ks[j * QS + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][cc] += dsv[a] * kk;
        }
      }
    }
  }

  SWA_T* dqb = dq + ((long long)b * S * H + h) * SWA_D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= S) continue;
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) {
      const int d = tx + 16 * cc;
      if (SWA_D % 16 == 0 || d < SWA_D)
        st(dqb + (long long)(q0 + r) * H * SWA_D + d, acc[a][cc] * scale);
    }
  }
}

__global__ void __launch_bounds__(NT) swa_bwd_dkdv(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, const SWA_T* __restrict__ dout,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ d_in, SWA_T* __restrict__ dk,
    SWA_T* __restrict__ dv, int S, int H, int G, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long gsb, long long gss, long long gsh, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = (float*)smem_raw;      // BK x QS
  float* vs = ks + BK * QS;          // BK x QS
  float* qs = vs + BK * QS;          // BQ x QS
  float* gs = qs + BQ * QS;          // BQ x QS: dout
  float* ps = gs + BQ * QS;          // BK x PS: P, then dS, key-major
  float* m_s = ps + BK * PS;         // the chunk's rows: max, sum, D
  float* l_s = m_s + BQ;
  float* d_s = l_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int KV = H / G;
  stage(ks, k + b * ksb + kvh * ksh, kss, j0, S, tid);
  stage(vs, v + b * vsb + kvh * vsh, vss, j0, S, tid);

  // keys ty + 16a, columns tx + 16cc of dk and dv
  float ak[4][DB], av[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) ak[a][c] = av[a][c] = 0.0f;

  const int j_last = min(j0 + BK, S) - 1;
  const int i_last = min(S - 1, j_last + window - 1);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const SWA_T* qb = q + b * qsb + h * qsh;
    const SWA_T* gb = dout + b * gsb + h * gsh;
    const long long row0 = ((long long)b * H + h) * S;
    for (int i0 = j0; i0 <= i_last; i0 += BQ) {
      __syncthreads();  // the last chunk's readers of qs, gs, ps are done
      stage(qs, qb, qss, i0, S, tid);
      stage(gs, gb, gss, i0, S, tid);
      if (tid < BQ) {
        const bool in = i0 + tid < S;
        m_s[tid] = in ? m_in[row0 + i0 + tid] : 0.0f;
        l_s[tid] = in ? l_in[row0 + i0 + tid] : 1.0f;
        d_s[tid] = in ? d_in[row0 + i0 + tid] : 0.0f;
      }
      __syncthreads();
      // s and dout.v of keys ty + 16a against query rows tx + 16c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
      for (int d = 0; d < SWA_D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kv[a] = ks[(ty + 16 * a) * QS + d];
          vv[a] = vs[(ty + 16 * a) * QS + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = qs[(tx + 16 * c) * QS + d];
          gv[c] = gs[(tx + 16 * c) * QS + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] += kv[a] * qv[c];
            dp[a][c] += vv[a] * gv[c];
          }
      }
      float p[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kj = j0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c, qi = i0 + r;
          const bool ok = qi < S && kj <= qi && kj > qi - window;
          p[a][c] = ok ? expf(s[a][c] * scale - m_s[r]) / l_s[r] : 0.0f;
          ps[(ty + 16 * a) * PS + r] = p[a][c];
        }
      }
      __syncthreads();
      // dv += P^T dout
      for (int i = 0; i < BQ; ++i) {
        float pv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * PS + i];
#pragma unroll
        for (int cc = 0; cc < DB; ++cc) {
          const int d = tx + 16 * cc;
          if (SWA_D % 16 == 0 || d < SWA_D) {
            const float gg = gs[i * QS + d];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a][cc] += pv[a] * gg;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c;
          ps[(ty + 16 * a) * PS + r] = p[a][c] * (dp[a][c] - d_s[r]);
        }
      __syncthreads();
      // dk += dS^T q
      for (int i = 0; i < BQ; ++i) {
        float dsv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dsv[a] = ps[(ty + 16 * a) * PS + i];
#pragma unroll
        for (int cc = 0; cc < DB; ++cc) {
          const int d = tx + 16 * cc;
          if (SWA_D % 16 == 0 || d < SWA_D) {
            const float qq = qs[i * QS + d];
#pragma unroll
            for (int a = 0; a < 4; ++a) ak[a][cc] += dsv[a] * qq;
          }
        }
      }
    }
  }

  const long long base = ((long long)b * S * KV + kvh) * SWA_D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = j0 + ty + 16 * a;
    if (kj >= S) continue;
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) {
      const int d = tx + 16 * cc;
      if (SWA_D % 16 == 0 || d < SWA_D) {
        const long long at = base + (long long)kj * KV * SWA_D + d;
        st(dk + at, ak[a][cc] * scale);
        st(dv + at, av[a][cc]);
      }
    }
  }
}

extern "C" int swa_bwd_smem_bytes() {
  return (int)(DQ_SMEM_FLOATS * sizeof(float));
}

extern "C" int swa_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* m, void* l,
    void* d, int B, int S, int H, int KV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss,
    long long gsh, int window, float scale, void* stream) {
  const int smem_dq = DQ_SMEM_FLOATS * sizeof(float);
  const int smem_dkdv = DKDV_SMEM_FLOATS * sizeof(float);
  // the shared-memory attribute is a device's: set once on each device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(swa_bwd_dq,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(swa_bwd_dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_dkdv);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int G = H / KV;
  const dim3 grid_dq((S + BQ - 1) / BQ, H, B);
  swa_bwd_dq<<<grid_dq, NT, smem_dq, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (const SWA_T*)o,
      (const SWA_T*)dout, (SWA_T*)dq, (float*)m, (float*)l, (float*)d, S, H,
      G, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb,
      gss, gsh, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_dkdv((S + BK - 1) / BK, KV, B);
  swa_bwd_dkdv<<<grid_dkdv, NT, smem_dkdv, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (const SWA_T*)dout,
      (const float*)m, (const float*)l, (const float*)d, (SWA_T*)dk,
      (SWA_T*)dv, S, H, G, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, gsb,
      gss, gsh, window, scale);
  return (int)cudaGetLastError();
}
