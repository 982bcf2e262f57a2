// Eq. (8) interactive graph-attention scores, forward and backward, fp32,
// for sm_90a (kernel C).
//
// Replaces the TPU kernels digat_tpu/ops/pallas/gat_scores.py
// (interactive_gat_scores_pallas -> _scores_kernel, and its custom-VJP
// backward _bwd_kernel). For each graph b:
//
//     s[i, j]  = a . relu(k1[j] + k2[i] + k3)                 (forward)
//     m        = (k1[j] + k2[i] + k3 > 0)
//     gk1[j]   = a * sum_i g[i, j] m[i, j]                   (backward)
//     gk2[i]   = a * sum_j g[i, j] m[i, j]
//     gk3      = sum_i gk2[i]
//     ga       = sum_b sum_ij g[i, j] relu(k1[j] + k2[i] + k3)
//
// What bounds it on an H100: arithmetic. Each (b, i, j, d) costs about 4
// operations forward and 6 backward, against 4 * B * G * D bytes of k1 and
// k2: at B 320, G 68, D 400 that is 2.4 (forward) and 3.6 (backward)
// GFLOP over 70 MB, about 34 FLOP per byte.
//
// Design. Like the TPU kernels, neither pass ever forms [G, G, D]: the
// relu mask is recomputed in the backward, not stored. One block per graph.
//   forward: k1 and k2 + k3 of the graph sit in shared memory with a padded
//     row stride (D + 1), and each thread takes (i, j) pairs, j fastest, so
//     the lanes of a warp read k1 rows from 32 different banks while the
//     k2 row is a broadcast; G 68 needs 218 KB, one block per SM.
//   backward: one thread per feature d. The first sweep keeps k1 in shared
//     memory and walks i then j, giving gk2, gk3 and this graph's share of
//     ga; the second keeps k2 + k3 and walks j then i, giving gk1. Each
//     thread owns its column, so there are no atomics. ga is summed over
//     the graphs by a second pass in graph order.
// k1 and k2 may be column blocks of a wider row-major array (the fused
// projection y = x [W|W1|W2]): rows are read with their own row stride.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

int g_max_smem = 0;  // opt-in shared memory per block, set by gat_scores_init

__host__ __device__ inline size_t fwd_smem_floats(int G, int D) {
  return 2 * size_t(G) * (D + 1) + D;
}

__host__ __device__ inline size_t bwd_smem_floats(int G, int D) {
  return size_t(G) * D + size_t(G) * G;
}

__global__ void __launch_bounds__(kThreads)
gat_scores_fwd_kernel(const float* __restrict__ k1, int ld1, const float* __restrict__ k2,
                      int ld2, const float* __restrict__ k3, const float* __restrict__ a,
                      float* __restrict__ out, int G, int D) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* K1 = smem;            // [G][D+1]
  float* K2 = K1 + G * Dp;     // [G][D+1]: k2 + k3
  float* As = K2 + G * Dp;     // [D]
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    K1[j * Dp + d] = k1[(b * G + j) * ld1 + d];
    K2[j * Dp + d] = k2[(b * G + j) * ld2 + d] + k3[b * D + d];
  }
  for (int d = threadIdx.x; d < D; d += kThreads) As[d] = a[d];
  __syncthreads();
  float* ob = out + b * G * G;
  for (int p = threadIdx.x; p < G * G; p += kThreads) {
    const int i = p / G, j = p - i * G;
    const float* kj = K1 + j * Dp;
    const float* ci = K2 + i * Dp;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(As[d], fmaxf(kj[d] + ci[d], 0.f), s);
    ob[p] = s;
  }
}

__global__ void __launch_bounds__(1024)
gat_scores_bwd_kernel(const float* __restrict__ k1, int ld1, const float* __restrict__ k2,
                      int ld2, const float* __restrict__ k3, const float* __restrict__ a,
                      const float* __restrict__ g, float* __restrict__ gk1,
                      float* __restrict__ gk2, float* __restrict__ gk3,
                      float* __restrict__ ga_part, int G, int D) {
  extern __shared__ float smem[];
  float* T = smem;          // [G][D]: k1 rows, then k2 + k3 rows
  float* gs = T + G * D;    // [G][G]
  const size_t b = blockIdx.x;
  const int nt = blockDim.x;
  for (int e = threadIdx.x; e < G * D; e += nt) {
    const int j = e / D, d = e - j * D;
    T[e] = k1[(b * G + j) * ld1 + d];
  }
  for (int e = threadIdx.x; e < G * G; e += nt) gs[e] = g[b * G * G + e];
  __syncthreads();
  // sweep 1: centre rows i -> gk2, gk3, ga
  for (int d = threadIdx.x; d < D; d += nt) {
    const float ad = a[d], k3d = k3[b * D + d];
    float sum3 = 0.f, ga = 0.f;
    for (int i = 0; i < G; ++i) {
      const float c = k2[(b * G + i) * ld2 + d] + k3d;
      const float* gi = gs + i * G;
      float acc = 0.f, gai = 0.f;  // row sums first: ga adds G row sums, not G * G terms
      for (int j = 0; j < G; ++j) {
        const float t = T[j * D + d] + c;
        const float w = t > 0.f ? gi[j] : 0.f;
        acc += w;
        gai = fmaf(w, t, gai);
      }
      gk2[(b * G + i) * D + d] = ad * acc;
      sum3 += acc;
      ga += gai;
    }
    gk3[b * D + d] = ad * sum3;
    ga_part[b * D + d] = ga;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += nt) {
    const int i = e / D, d = e - i * D;
    T[e] = k2[(b * G + i) * ld2 + d] + k3[b * D + d];
  }
  __syncthreads();
  // sweep 2: neighbours j -> gk1
  for (int d = threadIdx.x; d < D; d += nt) {
    const float ad = a[d];
    for (int j = 0; j < G; ++j) {
      const float kj = k1[(b * G + j) * ld1 + d];
      float acc = 0.f;
      for (int i = 0; i < G; ++i) {
        const float t = kj + T[i * D + d];
        acc += t > 0.f ? gs[i * G + j] : 0.f;
      }
      gk1[(b * G + j) * D + d] = ad * acc;
    }
  }
}

// ga[d] = sum over graphs b, in order, of ga_part[b][d]
__global__ void sum_graphs_kernel(const float* __restrict__ part, float* __restrict__ out, int B,
                                  int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * D + d];
  out[d] = s;
}

}  // namespace

extern "C" int gat_scores_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_scores_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_smem);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_scores_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_smem);
  }
  return static_cast<int>(e);
}

// s [B, G, G] from k1, k2 (rows of ld1 / ld2 floats, graph b's rows at
// b * G), k3 [B, D], a [D].
extern "C" int gat_scores_fwd_f32(const void* k1, int ld1, const void* k2, int ld2,
                                  const void* k3, const void* a, void* out, int B, int G, int D,
                                  void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || ld1 < D || ld2 < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * fwd_smem_floats(G, D);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  gat_scores_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k1), ld1, static_cast<const float*>(k2), ld2,
      static_cast<const float*>(k3), static_cast<const float*>(a), static_cast<float*>(out), G,
      D);
  return static_cast<int>(cudaGetLastError());
}

// gk1, gk2 [B, G, D], gk3 [B, D], ga [D] from the score gradient g [B, G, G];
// ga_part [B, D] is scratch.
extern "C" int gat_scores_bwd_f32(const void* k1, int ld1, const void* k2, int ld2,
                                  const void* k3, const void* a, const void* g, void* gk1,
                                  void* gk2, void* gk3, void* ga, void* ga_part, int B, int G,
                                  int D, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || ld1 < D || ld2 < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * bwd_smem_floats(G, D);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int threads = (D + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  gat_scores_bwd_kernel<<<B, threads, smem, st>>>(
      static_cast<const float*>(k1), ld1, static_cast<const float*>(k2), ld2,
      static_cast<const float*>(k3), static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<float*>(gk1), static_cast<float*>(gk2), static_cast<float*>(gk3),
      static_cast<float*>(ga_part), G, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_graphs_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(ga_part), static_cast<float*>(ga), B, D);
  return static_cast<int>(cudaGetLastError());
}
