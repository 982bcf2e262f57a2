// Fused interactive GAT layer, eval forward, fp32 (and with bf16 weights),
// for sm_90a (kernel B).
//
// Replaces the TPU kernel digat_tpu/ops/pallas/gat_layer.py
// (interactive_gat_layer_fused -> _layer_kernel). For each graph b:
//
//     h  = x W + bW        k1 = x W1        k2 = x W2        k3 = q W3 + b3
//     s[i, j]  = a . relu(k1[j] + (k2[i] + k3))        (Eq. 8 scores)
//     alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
//     out      = relu(alpha h) + x
//
// What bounds it on an H100: the projections. At B 1,024, G 68, D 400 they
// are 2 B G D 3D = 67 GFLOP; the score sweep is about 4 B G G D = 7.6 GFLOP
// on the CUDA cores and the aggregation 2 B G G D = 3.8 GFLOP, against about
// 0.23 GB of inputs and outputs. On the fp32 CUDA cores that is 1.17 ms; with
// the projections on the tensor cores at 3xTF32 (three TF32 products per
// fp32 product) about 0.65 ms.
//
// Design: three launches that the one wrapper call (ops/gat_layer.py) makes
// on the caller's stream, through scratch that the wrapper allocates:
//   1. gat_layer_project_f32: y = x [W|W1|W2]^T + [bW|0|0] ([B G, 3Dp]) and
//      k3 = q W3^T + b3 ([B, Dp]) on the tensor cores at 3xTF32
//      (tc_gemm.cuh, K-major x and nn.Linear weights, BN 96), each 32-deep
//      k-tile's sums added to the running sums rounding to nearest (kRN):
//      the tensor cores' own accumulation rounds toward zero, which moved
//      kernel A's outputs several times further from the exact product than
//      an fp32 product (PERF.md) and would move B's scores and the serving
//      rank file the same way. The wrapper stacks W, W1 and W2 into
//      one [3Dp, Dp] weight, because the 96-wide column tiles cross the
//      blocks' boundaries. Dp is D rounded up to a multiple of 4 (float4
//      loads): where D is not one, the wrapper pads x, q and the weights
//      with zeros, and the padded columns of y and k3 come out 0.
//   2. kernel C's forward (gat_scores.cu, gat_scores_fwd_f32, its launch
//      plan from ops/gat_scores.py) on y's column blocks k1 = y[:, Dp:2Dp]
//      and k2 = y[:, 2Dp:3Dp] in place (row stride 3Dp), writing s
//      [B, G, G]: register tiles of R x R scores, features staged in
//      transposed 32-wide slices, each score summed over d in order from 0.
//      The padded features carry a = 0 and add nothing.
//   3. gat_layer_attend_kernel, the rest. A block takes one graph, a tile of
//      TI rows i (TI <= 32, a multiple of 4) and a slice of 4 CG features:
//      it stages h[:, slice] ([G][4 CG]) in shared memory, forms its rows'
//      leaky ReLU, mask and softmax over j (a warp per row, a lane per j; a
//      row with no neighbour becomes uniform, as in the reference) into
//      alpha^T [G][TI], and each thread keeps a 4 x 4 register tile of
//      outputs (4 rows, one float4 of features), reading one float4 of
//      alpha and one of h per j for 16 multiply-adds. Sums over j run in
//      order from 0. A block holds a few tens of KB (43.5 KB at G 68, D 400:
//      three row tiles of 24, three slices of 136 features), so several
//      blocks run per SM; the one-block-per-graph kernel this replaces held
//      142 KB and read two shared words per multiply-add.
// bf16 weights (gat_layer_project_bf16, compute_dtype bfloat16): x, q, y,
// k3 and the vectors stay fp32; W|W1|W2 and W3 are read as bf16 (half the
// bytes: 0.96 MB of stacked weights at D 400) and step 1 runs at 2xTF32, x
// split into two TF32 parts and each bf16 weight exact in one: each
// product as accurate as the fp32 instance's, two passes in place of three.
// Steps 2 and 3 are the fp32 ones.
//
// Every reduction runs in a fixed order with no atomics: the same bits on
// every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

namespace tc = digat::tc;
using digat::warp_max;
using digat::warp_sum;

constexpr int kBN = 96;  // the products' tile width: kRN's second set of accumulators fits
constexpr int kRI = 4;   // rows of a thread's output tile
constexpr int kMaxRows = 32;  // rows i of an attend block
constexpr int kMaxAttendThreads = 256;
constexpr float kMaskFill = -1e9f;

int g_max_smem = 0;  // opt-in shared memory per block, set by gat_layer_init

// h's slice [G][4 CG] and alpha^T [G][TI]
__host__ __device__ inline size_t attend_smem_floats(int G, int TI, int CG) {
  return size_t(G) * (4 * CG + TI);
}

// grid (slices of D, tiles of rows, B); block round32(TI / 4 * CG) threads
template <bool V4>
__global__ void __launch_bounds__(kMaxAttendThreads)
gat_layer_attend_kernel(const float* __restrict__ x,            // [B, G, D]
                        const unsigned char* __restrict__ adj,  // [B, G, G]
                        const float* __restrict__ s,            // [B, G, G] scores
                        const float* __restrict__ h, int ldh,   // [B G, ldh]: h in 0..D
                        float* __restrict__ out,                // [B, G, D]
                        int G, int D, int TI, int CG, float slope) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DS = 4 * CG;
  float4* Hs = smem4;          // [G][CG] float4: h of the slice, zero past D
  float* At = smem + G * DS;   // [G][TI]: alpha transposed, zero past the tile's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t b = blockIdx.z;
  const int i0 = blockIdx.y * TI, d0 = blockIdx.x * DS;
  const int rows = min(TI, G - i0);

  const float* hb = h + b * G * ldh;
  for (int e = tid; e < G * CG; e += blockDim.x) {
    const int j = e / CG, dj = d0 + 4 * (e - j * CG);
    Hs[e] = dj < D ? __ldg(reinterpret_cast<const float4*>(hb + (size_t)j * ldh + dj))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // leaky ReLU, the mask and the softmax over j of each row: lane j keeps
  // its own entries of alpha^T
  const float* sb = s + (b * G + i0) * G;
  const unsigned char* ab = adj + (b * G + i0) * G;
  for (int r = warp; r < TI; r += nwarps) {
    if (r >= rows) {
      for (int j = lane; j < G; j += 32) At[j * TI + r] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < G; j += 32) {
      const float v = sb[(size_t)r * G + j];
      const float e = ab[(size_t)r * G + j] ? (v > 0.f ? v : slope * v) : kMaskFill;
      At[j * TI + r] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < G; j += 32) {
      const float p = expf(At[j * TI + r] - m);
      At[j * TI + r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < G; j += 32) At[j * TI + r] = At[j * TI + r] / sum;
  }
  __syncthreads();

  // out = relu(alpha h) + x: a 4 x 4 tile a thread, j in order from 0
  const int c = tid % CG, rg = tid / CG;
  if (rg >= TI / kRI) return;
  float acc[kRI][4];
#pragma unroll
  for (int r = 0; r < kRI; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  const float* ar = At + rg * kRI;
#pragma unroll 4
  for (int j = 0; j < G; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(ar + j * TI);
    const float4 v = Hs[j * CG + c];
    const float al[kRI] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < kRI; ++r) {
      acc[r][0] = fmaf(al[r], v.x, acc[r][0]);
      acc[r][1] = fmaf(al[r], v.y, acc[r][1]);
      acc[r][2] = fmaf(al[r], v.z, acc[r][2]);
      acc[r][3] = fmaf(al[r], v.w, acc[r][3]);
    }
  }
  const int d = d0 + 4 * c;
  if (d >= D) return;
#pragma unroll
  for (int r = 0; r < kRI; ++r) {
    const int i = rg * kRI + r;
    if (i >= rows) break;
    const size_t row = (b * G + i0 + i) * (size_t)D;
    if (V4) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + row + d));
      *reinterpret_cast<float4*>(out + row + d) =
          make_float4(fmaxf(acc[r][0], 0.f) + xv.x, fmaxf(acc[r][1], 0.f) + xv.y,
                      fmaxf(acc[r][2], 0.f) + xv.z, fmaxf(acc[r][3], 0.f) + xv.w);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) out[row + d + q] = fmaxf(acc[r][q], 0.f) + x[row + d + q];
    }
  }
}

}  // namespace

// Grants the projections and the attend kernel their shared memory on the
// current device. Called once per device, when the library is loaded.
extern "C" int gat_layer_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = tc::init<true, true, kBN, tc::kBias, true>();
  if (e == cudaSuccess) e = tc::init<true, true, kBN, tc::kBias, true, __nv_bfloat16>();
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_layer_attend_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_layer_attend_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  }
  return static_cast<int>(e);
}

namespace {

// Step 1 with the weights of type TW (float: 3xTF32; bf16: 2xTF32).
template <typename TW>
cudaError_t project(const void* x, const void* q, const void* wy, const void* by,
                    const void* w3, const void* b3, void* y, void* k3, int M, int B, int Dp,
                    cudaStream_t st) {
  if (M <= 0 || B <= 0 || Dp <= 0 || Dp % 4) return cudaErrorInvalidValue;
  tc::Args a{};
  a.A = x;
  a.B = wy;
  a.C = y;
  a.M = M;
  a.N = 3 * Dp;
  a.K = Dp;
  a.lda = Dp;
  a.ldb = Dp;
  a.ldc = 3 * Dp;
  a.k_per_split = Dp;
  a.bias = static_cast<const float*>(by);
  cudaError_t e = tc::gemm<true, true, kBN, tc::kBias, true, TW>(st, a);
  if (e != cudaSuccess) return e;
  a.A = q;
  a.B = w3;
  a.C = k3;
  a.M = B;
  a.N = Dp;
  a.ldc = Dp;
  a.bias = static_cast<const float*>(b3);
  return tc::gemm<true, true, kBN, tc::kBias, true, TW>(st, a);
}

}  // namespace

// Step 1: y = x wy^T + by and k3 = q w3^T + b3. x [M, Dp] (M = B G rows),
// q [B, Dp], wy [3Dp, Dp] (W, W1, W2 stacked, nn.Linear layout), by [3Dp]
// ([bW | 0 | 0]), w3 [Dp, Dp], b3 [Dp]; y [M, 3Dp], k3 [B, Dp]. Dp a
// multiple of 4 and every array 16-byte aligned. fp32 throughout.
extern "C" int gat_layer_project_f32(const void* x, const void* q, const void* wy,
                                     const void* by, const void* w3, const void* b3, void* y,
                                     void* k3, int M, int B, int Dp, void* stream) {
  return static_cast<int>(project<float>(x, q, wy, by, w3, b3, y, k3, M, B, Dp,
                                         static_cast<cudaStream_t>(stream)));
}

// The same with wy and w3 bf16 (x, q, the biases, y and k3 fp32).
extern "C" int gat_layer_project_bf16(const void* x, const void* q, const void* wy,
                                      const void* by, const void* w3, const void* b3, void* y,
                                      void* k3, int M, int B, int Dp, void* stream) {
  return static_cast<int>(project<__nv_bfloat16>(x, q, wy, by, w3, b3, y, k3, M, B, Dp,
                                                 static_cast<cudaStream_t>(stream)));
}

// Step 3: out [B, G, D] from x [B, G, D], adj [B, G, G] (bytes), the
// scores s [B, G, G] and h, the first D columns of rows of ldh floats (ldh a
// multiple of 4, 16-byte aligned, columns up to D rounded to 4 readable).
// The plan (gat_layer.py::attend_plan): TI rows (a multiple of 4, at most
// 32) and 4 CG features a block, TI / 4 * CG <= 256 threads.
extern "C" int gat_layer_attend_f32(const void* x, const void* adj, const void* s,
                                    const void* h, int ldh, void* out, int B, int G, int D,
                                    int TI, int CG, float slope, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || ldh < D || ldh % 4 || TI <= 0 || TI % kRI ||
      TI > kMaxRows || CG <= 0 || TI / kRI * CG > kMaxAttendThreads ||
      reinterpret_cast<uintptr_t>(h) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * attend_smem_floats(G, TI, CG);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + 4 * CG - 1) / (4 * CG), (G + TI - 1) / TI, B);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (TI / kRI * CG + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = D % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const float* px = static_cast<const float*>(x);
  const unsigned char* pa = static_cast<const unsigned char*>(adj);
  const float *ps = static_cast<const float*>(s), *ph = static_cast<const float*>(h);
  float* po = static_cast<float*>(out);
  if (v4) {
    gat_layer_attend_kernel<true><<<grid, threads, smem, st>>>(px, pa, ps, ph, ldh, po, G, D,
                                                               TI, CG, slope);
  } else {
    gat_layer_attend_kernel<false><<<grid, threads, smem, st>>>(px, pa, ps, ph, ldh, po, G, D,
                                                                TI, CG, slope);
  }
  return static_cast<int>(cudaGetLastError());
}
