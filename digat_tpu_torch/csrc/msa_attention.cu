// Masked multi-head self-attention, forward and backward, fp32, for sm_90a.
//
// Replaces two TPU kernels that compute the same function:
//   digat_tpu/ops/pallas/msa_attention_grouped.py (msa_attention_grouped:
//     _fwd_kernel, _bwd_kernel; heads padded to dkp = 128 / g lanes, g heads
//     per 128-lane group), and
//   digat_tpu/ops/pallas/msa_attention.py (msa_attention: _fwd_kernel,
//     _bwd_kernel; heads packed dk apart).
// For each sequence n and head h, with a the softmax over keys j:
//
//     s[i, j]  = where(keep[j], (q[i] . k[j]) * scale, -1e9)
//     a[i, :]  = softmax(s[i, :]),   out[i] = sum_j a[i, j] v[j]
//     dp[i, j] = do[i] . v[j],       t[i] = sum_j a[i, j] dp[i, j]
//     ds[i, j] = keep[j] ? a[i, j] (dp[i, j] - t[i]) * scale : 0
//     dq[i] = sum_j ds[i, j] k[j],  dk[j] = sum_i ds[i, j] q[i],
//     dv[j] = sum_i a[i, j] do[i]
//
// scale is 1 / sqrt(dk) with the true head width dk. The mask is a select,
// as the reference's masked_fill and the JAX package's XLA path take it, so
// a masked key passes no gradient (the TPU kernels add -1e9 instead; the two
// differ only on a sequence whose keys are all masked).
//
// Layout: element (n, l, h, c) of every [N, L, .] operand sits at
// n * L * rs + l * rs + h * hs + c. The packed layout (F) has rs = H * dk and
// hs = dk; the head-padded layout (E) has rs = H * dkp and hs = dkp, and its
// pad lanes c in [dk, dkp) of out, dq, dk and dv are written as zeros.
//
// What bounds it on an H100: at the NRMS shapes (L 32-50, dk 20) memory.
// The forward does 4 L dk FLOP per (i, j) against 16 L dk bytes per head,
// 8 FLOP per byte at L 32: below the 20 FLOP per byte where fp32 CUDA-core
// arithmetic (67 TFLOP/s) would take over from HBM (3.35 TB/s).
//
// Design: one block of 4 warps per (n, h), q, k and v of that head in shared
// memory (rows zero-padded to a multiple of 4 floats so the dot products read
// float4; k and v rows at an odd float4 stride, so 32 lanes reading 32 rows
// hit distinct banks), one warp per query row: each lane forms the scores of
// keys lane, lane + 32, ..., the warp reduces max and sum with shuffles, the
// probabilities go to the warp's row of shared memory, and lane c forms
// out[i, c]. The backward recomputes a, as the TPU kernel does, and walks the
// query rows in chunks of 32: each warp writes a row's a and ds to shared
// memory and its dq to memory; then each thread owns elements (j, c) of dk
// and dv in shared memory and adds the chunk's rows to them in row order. So
// no float atomics are used and every result is the same on every run. The
// sequence must fit shared memory (the wrapper checks it).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // query rows per backward pass over the keys
constexpr float kMaskFill = -1e9f;

int g_max_smem = 0;  // opt-in shared memory per block, set by msa_attention_init

// float4s of a q / do row (dk rounded up to 4), and of a k / v row (that, made
// odd so that lanes reading different rows use different banks)
__host__ __device__ inline int row4(int dk) { return (dk + 3) / 4; }
__host__ __device__ inline int kv_row4(int dk) { return row4(dk) | 1; }

__host__ __device__ inline size_t fwd_smem_floats(int L, int dk) {
  return 4 * (size_t(L) * row4(dk) + 2 * size_t(L) * kv_row4(dk)) + size_t(kWarps) * L + L;
}

__host__ __device__ inline size_t bwd_smem_floats(int L, int dk) {
  return 4 * (2 * size_t(L) * row4(dk) + 2 * size_t(L) * kv_row4(dk)) + 2 * size_t(L) * dk +
         2 * size_t(kChunk) * L + L;
}

__device__ __forceinline__ float dot4(const float4* __restrict__ a, const float4* __restrict__ b,
                                      int n4) {
  float s = 0.f;
  for (int u = 0; u < n4; ++u) {
    const float4 x = a[u], y = b[u];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// rows [L][dk] of head h of sequence n -> shared rows of `stride4` float4s,
// zero beyond dk
__device__ __forceinline__ void load_head(float4* __restrict__ dst, int stride4,
                                          const float* __restrict__ src, int L, int dk, int rs) {
  float* d = reinterpret_cast<float*>(dst);
  const int w = 4 * stride4;
  for (int e = threadIdx.x; e < L * w; e += kThreads) {
    const int l = e / w, c = e - l * w;
    d[e] = c < dk ? src[size_t(l) * rs + c] : 0.f;
  }
}

__device__ __forceinline__ void load_keep(int* __restrict__ keep,
                                          const unsigned char* __restrict__ mask, size_t n, int L) {
  for (int j = threadIdx.x; j < L; j += kThreads) keep[j] = mask == nullptr || mask[n * L + j];
}

// The warp's scores of query row q4 against every key into `row`, then
// exp(s - max) in place; returns the sum of the exponentials (every lane).
__device__ __forceinline__ float exp_scores(float* __restrict__ row, const float4* __restrict__ q4,
                                            const float4* __restrict__ K4, int ks,
                                            const int* __restrict__ keep, int L, int n4,
                                            float scale, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < L; j += 32) {
    const float s = keep[j] ? dot4(q4, K4 + j * ks, n4) * scale : kMaskFill;
    row[j] = s;
    m = fmaxf(m, s);
  }
  m = digat::warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    sum += e;
  }
  return digat::warp_sum(sum);
}

__global__ void __launch_bounds__(kThreads)
msa_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const unsigned char* __restrict__ mask,
                         float* __restrict__ out, int H, int L, int dk, int rs, int hs,
                         float scale) {
  extern __shared__ float4 smem4[];
  const int n4 = row4(dk), ks = kv_row4(dk);
  float4* Q4 = smem4;                                     // [L][n4]
  float4* K4 = Q4 + L * n4;                               // [L][ks]
  float4* V4 = K4 + L * ks;                               // [L][ks]
  float* P = reinterpret_cast<float*>(V4 + L * ks);       // [kWarps][L]
  int* keep = reinterpret_cast<int*>(P + kWarps * L);     // [L]
  const size_t n = blockIdx.x / H;
  const int h = blockIdx.x - int(n) * H;
  const size_t base = n * L * rs + size_t(h) * hs;
  load_head(Q4, n4, q + base, L, dk, rs);
  load_head(K4, ks, k + base, L, dk, rs);
  load_head(V4, ks, v + base, L, dk, rs);
  load_keep(keep, mask, n, L);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Vs = reinterpret_cast<const float*>(V4);
  float* row = P + warp * L;
  for (int i = warp; i < L; i += kWarps) {
    const float sum = exp_scores(row, Q4 + i * n4, K4, ks, keep, L, n4, scale, lane);
    for (int j = lane; j < L; j += 32) row[j] = row[j] / sum;
    __syncwarp();
    for (int c = lane; c < hs; c += 32) {
      float o = 0.f;
      if (c < dk) {
        for (int j = 0; j < L; ++j) o = fmaf(row[j], Vs[j * 4 * ks + c], o);
      }
      out[base + size_t(i) * rs + c] = o;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
msa_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const unsigned char* __restrict__ mask,
                         const float* __restrict__ dout, float* __restrict__ dq,
                         float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int L,
                         int dk, int rs, int hs, float scale) {
  extern __shared__ float4 smem4[];
  const int n4 = row4(dk), ks = kv_row4(dk);
  float4* Q4 = smem4;                                     // [L][n4]
  float4* D4 = Q4 + L * n4;                               // [L][n4]: do
  float4* K4 = D4 + L * n4;                               // [L][ks]
  float4* V4 = K4 + L * ks;                               // [L][ks]
  float* dK = reinterpret_cast<float*>(V4 + L * ks);      // [L][dk]
  float* dV = dK + L * dk;                                // [L][dk]
  float* P = dV + L * dk;                                 // [kChunk][L]: a
  float* S = P + kChunk * L;                              // [kChunk][L]: ds
  int* keep = reinterpret_cast<int*>(S + kChunk * L);     // [L]
  const size_t n = blockIdx.x / H;
  const int h = blockIdx.x - int(n) * H;
  const size_t base = n * L * rs + size_t(h) * hs;
  load_head(Q4, n4, q + base, L, dk, rs);
  load_head(D4, n4, dout + base, L, dk, rs);
  load_head(K4, ks, k + base, L, dk, rs);
  load_head(V4, ks, v + base, L, dk, rs);
  load_keep(keep, mask, n, L);
  for (int e = threadIdx.x; e < 2 * L * dk; e += kThreads) dK[e] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* Qs = reinterpret_cast<const float*>(Q4);
  const float* Ds = reinterpret_cast<const float*>(D4);
  const float* Ks = reinterpret_cast<const float*>(K4);
  for (int i0 = 0; i0 < L; i0 += kChunk) {
    const int rows = min(kChunk, L - i0);
    for (int r = warp; r < rows; r += kWarps) {
      const int i = i0 + r;
      float* a = P + r * L;
      float* ds = S + r * L;
      const float sum = exp_scores(a, Q4 + i * n4, K4, ks, keep, L, n4, scale, lane);
      float t = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float p = a[j] / sum;
        const float dp = dot4(D4 + i * n4, V4 + j * ks, n4);
        a[j] = p;
        ds[j] = dp;
        t = fmaf(p, dp, t);
      }
      t = digat::warp_sum(t);
      for (int j = lane; j < L; j += 32) ds[j] = keep[j] ? a[j] * (ds[j] - t) * scale : 0.f;
      __syncwarp();
      for (int c = lane; c < hs; c += 32) {
        float g = 0.f;
        if (c < dk) {
          for (int j = 0; j < L; ++j) g = fmaf(ds[j], Ks[j * 4 * ks + c], g);
        }
        dq[base + size_t(i) * rs + c] = g;
      }
    }
    __syncthreads();
    // dk[j, c] += sum_r ds[r, j] q[i0 + r, c]; dv[j, c] += sum_r a[r, j] do[i0 + r, c]
    for (int e = threadIdx.x; e < L * dk; e += kThreads) {
      const int j = e / dk, c = e - j * dk;
      float gk = dK[e], gv = dV[e];
      for (int r = 0; r < rows; ++r) {
        const int i = i0 + r;
        gk = fmaf(S[r * L + j], Qs[i * 4 * n4 + c], gk);
        gv = fmaf(P[r * L + j], Ds[i * 4 * n4 + c], gv);
      }
      dK[e] = gk;
      dV[e] = gv;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < L * hs; e += kThreads) {
    const int j = e / hs, c = e - j * hs;
    const size_t o = base + size_t(j) * rs + c;
    dk_out[o] = c < dk ? dK[j * dk + c] : 0.f;
    dv_out[o] = c < dk ? dV[j * dk + c] : 0.f;
  }
}

bool bad_geometry(int N, int H, int L, int dk, int rs, int hs) {
  return N <= 0 || H <= 0 || L <= 0 || dk <= 0 || hs < dk || rs < H * hs ||
         size_t(N) * H > size_t(INT_MAX);
}

}  // namespace

extern "C" int msa_attention_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(msa_attention_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(msa_attention_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  }
  return static_cast<int>(e);
}

// out [N, L, rs] from q, k, v [N, L, rs] and the optional key mask [N, L]
// (bytes, nonzero = keep; null = keep all).
extern "C" int msa_attention_fwd_f32(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int N, int H, int L, int dk,
                                     int rs, int hs, float scale, void* stream) {
  if (bad_geometry(N, H, L, dk, rs, hs)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * fwd_smem_floats(L, dk);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  msa_attention_fwd_kernel<<<N * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), H, L, dk, rs, hs,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// dq, dk, dv [N, L, rs] from q, k, v, the mask and the output gradient do.
extern "C" int msa_attention_bwd_f32(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, void* dq, void* dk_out,
                                     void* dv_out, int N, int H, int L, int dk, int rs, int hs,
                                     float scale, void* stream) {
  if (bad_geometry(N, H, L, dk, rs, hs)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * bwd_smem_floats(L, dk);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  msa_attention_bwd_kernel<<<N * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk_out), static_cast<float*>(dv_out), H, L,
      dk, rs, hs, scale);
  return static_cast<int>(cudaGetLastError());
}
