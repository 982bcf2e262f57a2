// Fused interactive GAT layer, eval forward, fp32, for sm_90a.
//
// Replaces the TPU kernel digat_tpu/ops/pallas/gat_layer.py
// (interactive_gat_layer_fused -> _layer_kernel). For each graph b:
//
//     h  = x W + bW        k1 = x W1        k2 = x W2        k3 = q W3 + b3
//     s[i, j]  = a . relu(k1[j] + k2[i] + k3)          (Eq. 8 scores)
//     alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
//     out      = relu(alpha h) + x
//
// What bounds it on an H100: arithmetic. At B = 1024, G = 68, D = 400 the
// projections are 2*B*G*D*3D = 67 GFLOP, the score sweep about 4*B*G*G*D =
// 7.6 GFLOP and the aggregation 2*B*G*G*D = 3.8 GFLOP, against about 0.2 GB
// of inputs and outputs: far above the fp32 ridge.
//
// Design, two steps that the one wrapper call launches on the caller's stream:
//   1. gat_layer_project_f32: the tiled fp32 GEMM of common.cuh writes
//      y = x [W|W1|W2] + [bW|0|0] ([B*G, 3D]) and, with the same kernel,
//      k3 = q W3 + b3 ([B, D]) into scratch that the wrapper allocates. It
//      reads each weight in nn.Linear layout ([out, in]) through its own
//      pointer, so nothing is packed per call. Full fp32 products, where the
//      TPU ran them at DEFAULT (bf16-pass) precision.
//   2. gat_layer_attend_f32, the rest:
//      one block per graph keeps k1 [G, D] in shared memory with a padded
//      row stride (D+1, so the 32 lanes of a warp, one neighbour j each,
//      read 32 different banks). A warp takes a centre row i, stages
//      k2[i] + k3 in shared memory, and each lane reduces over D for its j,
//      never storing the [G, G, D] sum. Leaky ReLU, the -1e9 mask and the
//      softmax over j follow per row (a row with no neighbour becomes
//      uniform, as in the reference). h then replaces k1 in shared memory
//      and the block writes relu(alpha h) + x.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskFill = -1e9f;

using digat::warp_max;
using digat::warp_sum;

int g_max_smem = 0;  // opt-in shared memory per block, set by gat_layer_init

__host__ __device__ inline size_t layer_smem_floats(int G, int D) {
  return size_t(G) * (D + 1) + size_t(G) * G + size_t(kWarps) * D + D;
}

__global__ void __launch_bounds__(kThreads)
gat_layer_kernel(const float* __restrict__ x,            // [B, G, D]
                 const unsigned char* __restrict__ adj,  // [B, G, G]
                 const float* __restrict__ y,            // [B, G, 3D]: h | k1 | k2
                 const float* __restrict__ k3,           // [B, D]
                 const float* __restrict__ a,            // [D]
                 float* __restrict__ out,                // [B, G, D]
                 int G, int D, float slope) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* T = smem;                 // [G][D+1]: k1 rows, then h rows
  float* S = T + G * Dp;           // [G][G]: scores, then alpha
  float* Cw = S + G * G;           // [kWarps][D]: k2[i] + k3 of the warp's row
  float* As = Cw + kWarps * D;     // [D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int D3 = 3 * D;
  const float* yb = y + b * G * D3;

  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    T[j * Dp + d] = yb[(size_t)j * D3 + D + d];
  }
  for (int d = tid; d < D; d += kThreads) As[d] = a[d];
  __syncthreads();

  // Eq. (8) scores: warp per centre row i, lane per neighbour j
  float* c = Cw + warp * D;
  for (int i = warp; i < G; i += kWarps) {
    for (int d = lane; d < D; d += 32) c[d] = yb[(size_t)i * D3 + 2 * D + d] + k3[b * D + d];
    __syncwarp();
    for (int j = lane; j < G; j += 32) {
      const float* kj = T + j * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(As[d], fmaxf(kj[d] + c[d], 0.f), s);
      S[i * G + j] = s;
    }
    __syncwarp();
  }
  __syncthreads();

  // leaky ReLU, mask, softmax over j
  const unsigned char* adjb = adj + b * G * G;
  for (int i = warp; i < G; i += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < G; j += 32) {
      const float s = S[i * G + j];
      float e = s > 0.f ? s : slope * s;
      e = adjb[i * G + j] ? e : kMaskFill;
      S[i * G + j] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < G; j += 32) {
      const float p = expf(S[i * G + j] - m);
      S[i * G + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < G; j += 32) S[i * G + j] = S[i * G + j] / sum;
  }
  __syncthreads();

  // h replaces k1, then out = relu(alpha h) + x
  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    T[j * Dp + d] = yb[(size_t)j * D3 + d];
  }
  __syncthreads();
  const float* xb = x + b * G * D;
  float* ob = out + b * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const float* al = S + i * G;
    float o = 0.f;
    for (int j = 0; j < G; ++j) o = fmaf(al[j], T[j * Dp + d], o);
    ob[e] = fmaxf(o, 0.f) + xb[e];
  }
}

}  // namespace

// Reads the card's opt-in shared-memory limit and grants it to the
// per-graph kernel. Called once, when the library is loaded.
extern "C" int gat_layer_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_smem);
  }
  return static_cast<int>(e);
}

// Step 1: y = x [W|W1|W2] + [bW|0|0] and k3 = q W3 + b3, weights [out, in].
extern "C" int gat_layer_project_f32(const void* x, const void* q, const void* w,
                                     const void* bW, const void* w1, const void* w2,
                                     const void* w3, const void* b3, void* y, void* k3,
                                     int B, int G, int D, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * G, N = 3 * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const digat::Mat wcat{{static_cast<const float*>(w), static_cast<const float*>(w1),
                         static_cast<const float*>(w2)}, D, D};
  const digat::Bias bias_y{{static_cast<const float*>(bW), nullptr, nullptr}, D};
  cudaError_t e = digat::gemm(st, digat::mat1(static_cast<const float*>(x), D), wcat, bias_y,
                              static_cast<float*>(y), M, N, D);
  if (e != cudaSuccess) return static_cast<int>(e);
  const digat::Bias bias_k3{{static_cast<const float*>(b3), nullptr, nullptr}, D};
  return static_cast<int>(digat::gemm(st, digat::mat1(static_cast<const float*>(q), D),
                                      digat::mat1(static_cast<const float*>(w3), D), bias_k3,
                                      static_cast<float*>(k3), B, D, D));
}

// Step 2: scores, mask, softmax over j, out = relu(alpha h) + x.
extern "C" int gat_layer_attend_f32(const void* x, const void* adj, const void* y,
                                    const void* k3, const void* a, void* out, int B, int G,
                                    int D, float slope, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * layer_smem_floats(G, D);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  gat_layer_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(adj),
      static_cast<const float*>(y), static_cast<const float*>(k3),
      static_cast<const float*>(a), static_cast<float*>(out), G, D, slope);
  return static_cast<int>(cudaGetLastError());
}
