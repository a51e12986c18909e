// Causal sliding-window attention for Hopper (sm_90a), on the CUDA cores
// in float32.  Built by repro_torch.kernels.swa, which defines SWA_T (the
// storage type: float or __nv_bfloat16) and SWA_D (the head dim) ahead of
// this file; one library per (SWA_T, SWA_D).
//
// q: (B, S, H, D), k and v: (B, S, KV, D), read through their strides (the
// head dim contiguous); query head h reads KV head h / (H / KV).  Query i
// attends to keys (i - window, i].  o: (B, S, H, D) contiguous, in SWA_T.
// When lse is not null, each row's log-sum-exp of its scaled scores goes
// to lse (B, H, S) float32, as swa_mma.cu stores it.
//
// One CTA of NT threads per (query tile of BQ rows, head, batch row).  The
// q tile is staged once in shared memory; the tile's key range
// [q0 - window + 1, q0 + BQ) is walked in chunks of BK rows, K and V staged
// in shared memory as float32, with an online softmax (running max and
// denominator per row) and the BQ x D output accumulated in registers.
// Masked keys contribute exp(-inf) = 0; every row sees its own position, so
// its denominator is never 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define BQ 64
#define BK 64
#define NT 256
#define DB ((SWA_D + 15) / 16)  // output columns a thread owns
#define QS (SWA_D + 1)          // q and k rows in shared memory (odd stride)
#define PS (BK + 1)             // score rows in shared memory
#define SMEM_FLOATS (BQ * QS + BK * QS + BK * SWA_D + BQ * PS + 8 * BQ + 3 * BQ)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(NT) swa_kernel(
    const SWA_T* __restrict__ q, const SWA_T* __restrict__ k,
    const SWA_T* __restrict__ v, SWA_T* __restrict__ o,
    float* __restrict__ lse, int S, int H, int G, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int window,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = (float*)smem_raw;      // BQ x QS
  float* ks = qs + BQ * QS;          // BK x QS
  float* vs = ks + BK * QS;          // BK x SWA_D
  float* ps = vs + BK * SWA_D;       // BQ x PS: scores, then weights
  float* rmax = ps + BQ * PS;        // BQ x 4 partial row maxima
  float* rsum = rmax + 4 * BQ;       // BQ x 4 partial row sums
  float* m_run = rsum + 4 * BQ;      // running row max
  float* l_run = m_run + BQ;         // running row denominator
  float* corr = l_run + BQ;          // this chunk's rescale of each row

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int sr = tid >> 2, sq = tid & 3;  // row statistics: row, quarter
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const SWA_T* qb = q + b * qsb + h * qsh;
  const SWA_T* kb = k + b * ksb + kvh * ksh;
  const SWA_T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * SWA_D; i += NT) {
    const int r = i / SWA_D, d = i % SWA_D;
    qs[r * QS + d] = (q0 + r < S) ? ld(qb + (q0 + r) * qss + d) : 0.0f;
  }
  if (tid < BQ) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  float acc[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) acc[a][c] = 0.0f;

  const int q_last = min(q0 + BQ, S) - 1;
  for (int k0 = max(0, q0 - window + 1); k0 <= q_last; k0 += BK) {
    __syncthreads();  // the last chunk's readers of ks, vs and ps are done
    for (int i = tid; i < BK * SWA_D; i += NT) {
      const int r = i / SWA_D, d = i % SWA_D;
      const bool in = k0 + r < S;
      ks[r * QS + d] = in ? ld(kb + (k0 + r) * kss + d) : 0.0f;
      vs[r * SWA_D + d] = in ? ld(vb + (k0 + r) * vss + d) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16a against keys tx + 16c
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

    // online softmax: four threads a row, sixteen keys each
    float mx = -INFINITY;
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, ps[sr * PS + sq * 16 + j]);
    rmax[4 * sr + sq] = mx;
    __syncthreads();
    const float m_new = fmaxf(
        fmaxf(fmaxf(rmax[4 * sr], rmax[4 * sr + 1]),
              fmaxf(rmax[4 * sr + 2], rmax[4 * sr + 3])), m_run[sr]);
    const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
    float sum = 0.0f;
    for (int j = 0; j < 16; ++j) {
      const float p = expf(ps[sr * PS + sq * 16 + j] - m_use);
      ps[sr * PS + sq * 16 + j] = p;
      sum += p;
    }
    rsum[4 * sr + sq] = sum;
    __syncthreads();
    if (sq == 0) {
      const float c = expf(m_run[sr] - m_use);  // 0 while the row is empty
      l_run[sr] = l_run[sr] * c + ((rsum[4 * sr] + rsum[4 * sr + 1])
                                   + (rsum[4 * sr + 2] + rsum[4 * sr + 3]));
      m_run[sr] = m_new;
      corr[sr] = c;
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty + 16a, columns tx + 16c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float c = corr[ty + 16 * a];
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) acc[a][cc] *= c;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int cc = 0; cc < DB; ++cc) {
        const int d = tx + 16 * cc;
        if (SWA_D % 16 == 0 || d < SWA_D) {
          const float vv = vs[j * SWA_D + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][cc] += pv[a] * vv;
        }
      }
    }
  }
  __syncthreads();

  if (lse != nullptr && tid < BQ && q0 + tid < S)
    lse[((long long)b * H + h) * S + q0 + tid] = m_run[tid]
                                                 + logf(l_run[tid]);
  SWA_T* ob = o + ((long long)b * S * H + h) * SWA_D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= S) continue;
    const float l = l_run[r];
#pragma unroll
    for (int cc = 0; cc < DB; ++cc) {
      const int d = tx + 16 * cc;
      if (SWA_D % 16 == 0 || d < SWA_D)
        st(ob + (long long)(q0 + r) * H * SWA_D + d, acc[a][cc] / l);
    }
  }
}

extern "C" int swa_smem_bytes() { return (int)(SMEM_FLOATS * sizeof(float)); }

extern "C" int swa_launch(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int S, int H, int KV,
                          long long qsb,
                          long long qss, long long qsh, long long ksb,
                          long long kss, long long ksh, long long vsb,
                          long long vss, long long vsh, int window,
                          float scale, void* stream) {
  const int smem = swa_smem_bytes();
  // the shared-memory attribute is a device's: set once on each device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev] && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        swa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  ready[dev] = true;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v, (SWA_T*)o,
      (float*)lse, S, H, H / KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      window, scale);
  return (int)cudaGetLastError();
}
