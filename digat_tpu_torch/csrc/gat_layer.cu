// Fused interactive GAT layer, eval forward, fp32 (with bf16 weights, and
// with bf16 activations), for sm_90a (kernel B).
//
// Replaces the TPU kernel digat_tpu/ops/pallas/gat_layer.py
// (interactive_gat_layer_fused -> _layer_kernel). For each graph b:
//
//     h  = x W + bW        k1 = x W1        k2 = x W2        k3 = q W3 + b3
//     s[i, j]  = a . relu(k1[j] + (k2[i] + k3))        (Eq. 8 scores)
//     alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
//     out      = relu(alpha h) + x
//
// What bounds the fp32 instance on an H100: the projections. At B 1,024,
// G 68, D 400 they are 2 B G D 3D = 67 GFLOP; the score sweep is about 4 B G G D = 7.6 GFLOP
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
// bf16 weights (compute_dtype bfloat16 where the news vectors stay fp32:
// MSA-DIGAT): x, q, y, k3, the vectors and out fp32, W|W1|W2 and W3 bf16,
// as the TPU kernel upcasts each weight and computes in fp32. Two steps,
// the bf16-activation instance's design with fp32 x and out:
//   1. gat_layer_project_bf16: x and q split into three bf16 planes each
//      (tc_wgmma.cuh split3_kernel: hi, mid, lo, which sum back to x within
//      2^-24 |x|), then y and k3 on wgmma fed by the TMA, three bf16 passes
//      (lo, mid, hi) against the exact bf16 weights: every partial product
//      exact in fp32, each 64-deep k-tile's sums added rounding to nearest.
//      Dp is D rounded up to a multiple of 8.
//   2. gat_layer_fused_f32: gat_layer_fused_kernel (below) with x read as
//      fp32 and out written fp32, not rounded. The scores never leave the
//      chip; kernel C's forward and the attend step are not launched.
// What bounds it: issue, as the bf16-activation instance (below), with the
// projections' three passes at 989 TFLOP/s (0.20 ms at B 1,024, G 68, D
// 400) and x read and out written at 4 bytes an element.
//
// bf16 activations (compute_dtype bfloat16 where the news vectors are bf16:
// CNN-DIGAT): x, q and the weights bf16, out bf16, as the TPU kernel reads x
// and writes out in x's dtype with its math in fp32 (gat_layer.py:51,95).
// Two launches, where the fp32 instance takes three:
//   1. gat_layer_project_bf16_act: y and k3 as in step 1, on wgmma fed by
//      the TMA (tc_wgmma.cuh; kernel A bf16's q|k|v instance, one bf16 pass:
//      every product exact in fp32, each 64-deep k-tile's sums added
//      rounding to nearest), y and k3 fp32. Dp is D rounded up to a multiple
//      of 8 here (the TMA's 16-byte rows).
//   2. gat_layer_fused_kernel: the scores, the mask, the softmax and the
//      aggregation of a tile of rows of one graph in one block; the scores
//      never leave the chip. Its rows' scores against every column are formed
//      in registers by gat_score_tile.cuh (c = k2 + k3 and k1 read from y as
//      fp32 16-byte chunks, the next slice in flight while the current one is
//      summed; each score as (P[j] + Q[i] + sum over d of a |k1 + c|) / 2,
//      two instructions an element) into alpha^T [G][TI] in shared memory,
//      then the leaky ReLU, the mask and the softmax over j as step 3, then
//      out = relu(alpha h) + x over slices of 4 CG features as step 3, h's
//      slices copied by cp.async (the next in flight while the current one
//      is summed), x read as bf16 and each output rounded once to bf16.
//      Plan: ops/gat_layer.py fused_plan (at G 68 a block takes a whole
//      graph, 320 threads, 60.1 KB; two blocks an SM).
// What bounds it: issue. The score loop's 2 fp32 instructions an (i, j, d)
// at 33.4 T a second, 0.113 ms at B 1,024, G 68, D 400; alpha h's FFMA
// 0.057 ms; the projections 0.068 ms at 989 TFLOP/s bf16 (0.238 ms in all),
// against y's round trip through device memory (0.33 GB each way, 0.2 ms).

// Every reduction runs in a fixed order with no atomics: the same bits on
// every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gat_score_tile.cuh"
#include "tc_gemm.cuh"
#include "tc_wgmma.cuh"

namespace {

namespace gs = digat::gs;
namespace tc = digat::tc;
namespace wg = digat::wg;
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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The fused kernel's leaky ReLU, mask and softmax over j of rows r = warp,
// warp + nwarps, ... < TI of a tile whose first `rows` rows are real, in
// place in at, alpha^T [G][lda] (a lane per j), as the attend kernel's:
// rows past `rows` become zero, and a row with no neighbour uniform, as in
// the reference. adj: the tile's rows. (The attend kernel reads its scores
// from device memory in the same loop; staging them first cost it 12 %.)
__device__ __forceinline__ void softmax_rows(float* at, int lda, const unsigned char* adj, int G,
                                             int TI, int rows, float slope, int warp, int nwarps,
                                             int lane) {
  for (int r = warp; r < TI; r += nwarps) {
    if (r >= rows) {
      for (int j = lane; j < G; j += 32) at[j * lda + r] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < G; j += 32) {
      const float v = at[j * lda + r];
      const float e = adj[(size_t)r * G + j] ? (v > 0.f ? v : slope * v) : kMaskFill;
      at[j * lda + r] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < G; j += 32) {
      const float p = expf(at[j * lda + r] - m);
      at[j * lda + r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < G; j += 32) at[j * lda + r] = at[j * lda + r] / sum;
  }
}

// acc[r][q] = the sum over j < G, in order from 0, of alpha[r][j] h[j][q]
// (fmaf) for four rows and four features: alpha^T's rows `lda` floats apart
// from `ar` (the four rows' float4), h's float4s `ldh` apart from `hv`.
__device__ __forceinline__ void aggregate(float (&acc)[kRI][4], const float* ar, int lda,
                                          const float4* hv, int ldh, int G) {
#pragma unroll
  for (int r = 0; r < kRI; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < G; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(ar + j * lda);
    const float4 v = hv[j * ldh];
    const float al[kRI] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < kRI; ++r) {
      acc[r][0] = fmaf(al[r], v.x, acc[r][0]);
      acc[r][1] = fmaf(al[r], v.y, acc[r][1]);
      acc[r][2] = fmaf(al[r], v.z, acc[r][2]);
      acc[r][3] = fmaf(al[r], v.w, acc[r][3]);
    }
  }
}

// out = relu(acc) + x at features d .. d + 3 (those < D) of the first
// min(4, nrows) of four rows from element `row` (D apart), x and out of
// type T (bf16: rounded once); V4: four at a time.
template <bool V4, typename T>
__device__ __forceinline__ void write_out(const float (&acc)[kRI][4], const T* x, T* out,
                                          size_t row, int D, int d, int nrows) {
#pragma unroll
  for (int r = 0; r < kRI; ++r, row += D) {
    if (r >= nrows) break;
    if (V4) {
      const float4 xv = digat::load4(x + row + d);
      digat::store4(out + row + d,
                    make_float4(fmaxf(acc[r][0], 0.f) + xv.x, fmaxf(acc[r][1], 0.f) + xv.y,
                                fmaxf(acc[r][2], 0.f) + xv.z, fmaxf(acc[r][3], 0.f) + xv.w));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) store1(out + row + d + q, fmaxf(acc[r][q], 0.f) + gs::to_f32(x[row + d + q]));
    }
  }
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
  aggregate(acc, At + rg * kRI, TI, Hs + c, CG, G);
  const int d = d0 + 4 * c;
  if (d < D) write_out<V4>(acc, x, out, (b * G + i0 + rg * kRI) * (size_t)D, D, d, rows - rg * kRI);
}

// alpha^T's row stride in the fused kernel for a tile of BI rows: BI
// rounded up to 4 (float4 reads of four rows), an odd number of float4s
__host__ __device__ inline int alpha_stride(int BI) {
  const int w = (BI + 3) & ~3;
  return (w / 4) % 2 ? w : w + 4;
}

// Shared memory of the fused kernel (floats): a and k3, alpha^T [G][SA], and
// the staged slices of the scores or, after them, two slices of h [G][CG]
// float4 (ops/gat_layer.py fused_smem_bytes).
__host__ __device__ inline size_t fused_smem_floats(int G, int Dp, int R, int TIb, int TJb,
                                                    int CG) {
  const size_t stage = gs::stage_floats(R * TIb, R * TJb), hs = size_t(2) * G * 4 * CG;
  return 2 * size_t(gs::slice_span(Dp)) + size_t(G) * alpha_stride(R * TIb) +
         (stage > hs ? stage : hs);
}

// h's features 4 (sl CG + cc) .. + 3 of rows j < G (zero from Dp) into
// hs[j][cc] by cp.async, one group
__device__ __forceinline__ void copy_h(float4* hs, const float* yb, size_t ldy, int Dp, int G,
                                       int CG, int sl, int tid, int nthreads) {
  for (int e = tid; e < G * CG; e += nthreads) {
    const int j = e / CG, col = 4 * (sl * CG + e - j * CG);
    const float* src = col < Dp ? yb + j * ldy + col : yb;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(wg::smem_u32(hs + e)),
                 "l"(src), "r"(col < Dp ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The fused step after the wgmma projections (the bf16-activation and the
// bf16-weight instance): grid (row tiles, B), block gs::tile_threads(R,
// TIb, TJb, 8) threads. x and out of type T (bf16 or fp32). y [B G][3 Dp]:
// h, k1 and k2 in its column blocks, zero from D to Dp; k3 [B][Dp], a [Dp]
// (zero past D). A block takes rows i0 .. i0 + R TIb - 1 of graph b: their
// scores against each tile of R TJb columns (gat_score_tile.cuh) into
// alpha^T, the softmax, then relu(alpha h) + x over slices of 4 CG
// features, a 4 x 4 tile a thread (row group rg, float4 column c).
template <typename T, int R, bool V4>
__global__ void __launch_bounds__(gs::kMaxThreads, 2)
gat_layer_fused_kernel(const T* __restrict__ x,                // [B, G, D]
                       const unsigned char* __restrict__ adj,  // [B, G, G]
                       const float* __restrict__ y, int Dp, const float* __restrict__ k3,
                       const float* __restrict__ a, T* __restrict__ out, int G, int D, int TIb,
                       int TJb, int CG, float slope) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = gs::slice_span(Dp), BI = R * TIb, BJ = R * TJb, SA = alpha_stride(BI);
  float* as = smem;             // [span]: a, zero past Dp
  float* k3s = as + span;       // [span]: the graph's k3
  float* At = k3s + span;       // [G][SA]: the tile's scores, then alpha, transposed
  float* work = At + G * SA;    // the staged slices, then h's two slices
  float4* hs = reinterpret_cast<float4*>(work);
  const size_t b = blockIdx.y, ldy = 3 * size_t(Dp);
  const int i0 = blockIdx.x * BI, rows = min(BI, G - i0);
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid / TJb, tj = tid - ti * TJb;
  const bool active = ti < TIb;
  const float* yb = y + b * G * ldy;
  for (int d = tid; d < span; d += nthreads) {
    as[d] = d < Dp ? a[d] : 0.f;
    k3s[d] = d < Dp ? k3[b * Dp + d] : 0.f;
  }
  __syncthreads();

  // 1. the tile's rows' scores, a tile of columns at a time, into At
  const gs::Rows<float> g{yb + Dp, yb + 2 * Dp, int(ldy), int(ldy), G, Dp};
  for (int j0 = 0; j0 < G; j0 += BJ) {
    float acc[R][R];
    gs::score_tile<R, float, true>(acc, g, i0, j0, TIb, TJb, as, k3s, work, active, ti, tj);
    if (!active) continue;
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ti + q * TIb, j = j0 + tj + r * TJb;
        if (i < rows && j < G) At[j * SA + i] = acc[q][r];
      }
  }
  // h's first slice in flight while the softmax runs (the staged slices are
  // free: score_tile ends with a barrier)
  const int slices = ((D + 3) / 4 + CG - 1) / CG;
  copy_h(hs, yb, ldy, Dp, G, CG, 0, tid, nthreads);
  __syncthreads();

  // 2. the leaky ReLU, the mask and the softmax of each row
  const int BI4 = (BI + 3) & ~3;
  softmax_rows(At, SA, adj + (b * G + i0) * G, G, BI4, rows, slope, warp, nthreads >> 5, lane);

  // 3. out = relu(alpha h) + x over the slices of h
  const int rg = tid / CG, c = tid - rg * CG;
  for (int sl = 0; sl < slices; ++sl) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // slice sl landed; alpha and the previous slice's reads done
    if (sl + 1 < slices) copy_h(hs + ((sl + 1) & 1) * G * CG, yb, ldy, Dp, G, CG, sl + 1, tid,
                                nthreads);
    if (rg >= BI4 / kRI) continue;
    float acc[kRI][4];
    aggregate(acc, At + rg * kRI, SA, hs + (sl & 1) * G * CG + c, CG, G);
    const int d = 4 * (sl * CG + c);
    if (d < D)
      write_out<V4>(acc, x, out, (b * G + i0 + rg * kRI) * (size_t)D, D, d, rows - rg * kRI);
  }
}

// the four instantiations of the fused kernel for x and out of type T
template <typename T>
cudaError_t set_fused_smem() {
  const void* kernels[] = {reinterpret_cast<const void*>(gat_layer_fused_kernel<T, 2, false>),
                           reinterpret_cast<const void*>(gat_layer_fused_kernel<T, 2, true>),
                           reinterpret_cast<const void*>(gat_layer_fused_kernel<T, 4, false>),
                           reinterpret_cast<const void*>(gat_layer_fused_kernel<T, 4, true>)};
  cudaError_t e = cudaSuccess;
  for (const void* kern : kernels) {
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
    }
  }
  return e;
}

}  // namespace

// Grants the projections, the attend kernel and the fused kernel their
// shared memory on the current device. Called once per device, when the
// library is loaded.
extern "C" int gat_layer_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = tc::init<true, true, kBN, tc::kBias, true>();
  if (e == cudaSuccess) e = wg::init<wg::kNx, 64, true, true, 1, 1, tc::kBias>();
  if (e == cudaSuccess) e = wg::init<wg::kNx, 64, true, true, 3, 1, tc::kBias>();
  const void* attend[] = {reinterpret_cast<const void*>(gat_layer_attend_kernel<true>),
                          reinterpret_cast<const void*>(gat_layer_attend_kernel<false>)};
  for (const void* kern : attend) {
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
    }
  }
  if (e == cudaSuccess) e = set_fused_smem<__nv_bfloat16>();
  if (e == cudaSuccess) e = set_fused_smem<float>();
  return static_cast<int>(e);
}

namespace {

// Step 1 of the fp32 instance, at 3xTF32.
cudaError_t project_f32(const void* x, const void* q, const void* wy, const void* by,
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
  cudaError_t e = tc::gemm<true, true, kBN, tc::kBias, true>(st, a);
  if (e != cudaSuccess) return e;
  a.A = q;
  a.B = w3;
  a.C = k3;
  a.M = B;
  a.N = Dp;
  a.ldc = Dp;
  a.bias = static_cast<const float*>(b3);
  return tc::gemm<true, true, kBN, tc::kBias, true>(st, a);
}

// Step 3 with x and out fp32.
int attend(const void* x, const void* adj, const void* s, const void* h, int ldh, void* out,
           int B, int G, int D, int TI, int CG, float slope, void* stream) {
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
  const bool v4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const float* px = static_cast<const float*>(x);
  const unsigned char* pa = static_cast<const unsigned char*>(adj);
  const float *ps = static_cast<const float*>(s), *ph = static_cast<const float*>(h);
  float* po = static_cast<float*>(out);
  if (v4) {
    gat_layer_attend_kernel<true><<<grid, threads, smem, st>>>(px, pa, ps, ph, ldh, po, G, D, TI,
                                                               CG, slope);
  } else {
    gat_layer_attend_kernel<false><<<grid, threads, smem, st>>>(px, pa, ps, ph, ldh, po, G, D,
                                                                TI, CG, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 1: y = x wy^T + by and k3 = q w3^T + b3. x [M, Dp] (M = B G rows),
// q [B, Dp], wy [3Dp, Dp] (W, W1, W2 stacked, nn.Linear layout), by [3Dp]
// ([bW | 0 | 0]), w3 [Dp, Dp], b3 [Dp]; y [M, 3Dp], k3 [B, Dp]. Dp a
// multiple of 4 and every array 16-byte aligned. fp32 throughout.
extern "C" int gat_layer_project_f32(const void* x, const void* q, const void* wy,
                                     const void* by, const void* w3, const void* b3, void* y,
                                     void* k3, int M, int B, int Dp, void* stream) {
  return static_cast<int>(project_f32(x, q, wy, by, w3, b3, y, k3, M, B, Dp,
                                       static_cast<cudaStream_t>(stream)));
}

// The same with wy and w3 bf16 (x, q, the biases, y and k3 fp32) on wgmma:
// x and q split into three bf16 planes each (split3_kernel) in `planes`
// (3 (M + B) Dp bf16: x's, then q's), then three bf16 passes of each
// against the exact bf16 weights. Dp a multiple of 8 (rows 16 bytes apart,
// as the TMA copies them); x and q 16-byte aligned.
extern "C" int gat_layer_project_bf16(const void* x, const void* q, const void* wy,
                                      const void* by, const void* w3, const void* b3, void* y,
                                      void* k3, void* planes, int M, int B, int Dp,
                                      void* stream) {
  if (M <= 0 || B <= 0 || Dp <= 0 || Dp % 8 || (long long)M * Dp / 4 >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xs = static_cast<bf16*>(planes);
  bf16* qs = xs + 3LL * M * Dp;
  wg::split3_kernel<<<wg::copy_blocks((long long)M * Dp / 4), wg::kCopyThreads, 0, st>>>(
      static_cast<const float*>(x), Dp, xs, M, Dp);
  wg::split3_kernel<<<wg::copy_blocks((long long)B * Dp / 4), wg::kCopyThreads, 0, st>>>(
      static_cast<const float*>(q), Dp, qs, B, Dp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tc::Args a{};
  a.C = y;
  a.M = M;
  a.N = 3 * Dp;
  a.K = Dp;
  a.ldc = 3 * Dp;
  a.k_per_split = Dp;
  a.bias = static_cast<const float*>(by);
  e = wg::gemm<wg::kNx, 64, true, true, 3, 1, tc::kBias>(
      st, wg::Operand{xs, M, Dp, Dp, (long long)M * Dp},
      wg::Operand{static_cast<const bf16*>(wy), 3 * Dp, Dp, Dp, 3LL * Dp * Dp}, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.C = k3;
  a.M = B;
  a.N = Dp;
  a.ldc = Dp;
  a.bias = static_cast<const float*>(b3);
  return static_cast<int>(wg::gemm<wg::kNx, 64, true, true, 3, 1, tc::kBias>(
      st, wg::Operand{qs, B, Dp, Dp, (long long)B * Dp},
      wg::Operand{static_cast<const bf16*>(w3), Dp, Dp, Dp, (long long)Dp * Dp}, a));
}

// The same with x, q, wy and w3 bf16 (the biases, y and k3 fp32) on wgmma:
// Dp a multiple of 8 (rows 16 bytes apart, as the TMA copies them).
extern "C" int gat_layer_project_bf16_act(const void* x, const void* q, const void* wy,
                                          const void* by, const void* w3, const void* b3,
                                          void* y, void* k3, int M, int B, int Dp,
                                          void* stream) {
  if (M <= 0 || B <= 0 || Dp <= 0 || Dp % 8) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::Args a{};
  a.C = y;
  a.M = M;
  a.N = 3 * Dp;
  a.K = Dp;
  a.ldc = 3 * Dp;
  a.k_per_split = Dp;
  a.bias = static_cast<const float*>(by);
  cudaError_t e = wg::gemm<wg::kNx, 64, true, true, 1, 1, tc::kBias>(
      st, wg::Operand{static_cast<const bf16*>(x), M, Dp, Dp, (long long)M * Dp},
      wg::Operand{static_cast<const bf16*>(wy), 3 * Dp, Dp, Dp, 3LL * Dp * Dp}, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.C = k3;
  a.M = B;
  a.N = Dp;
  a.ldc = Dp;
  a.bias = static_cast<const float*>(b3);
  return static_cast<int>(wg::gemm<wg::kNx, 64, true, true, 1, 1, tc::kBias>(
      st, wg::Operand{static_cast<const bf16*>(q), B, Dp, Dp, (long long)B * Dp},
      wg::Operand{static_cast<const bf16*>(w3), Dp, Dp, Dp, (long long)Dp * Dp}, a));
}

// Step 3: out [B, G, D] from x [B, G, D], adj [B, G, G] (bytes), the
// scores s [B, G, G] and h, the first D columns of rows of ldh floats (ldh a
// multiple of 4, 16-byte aligned, columns up to D rounded to 4 readable).
// The plan (gat_layer.py::attend_plan): TI rows (a multiple of 4, at most
// 32) and 4 CG features a block, TI / 4 * CG <= 256 threads.
extern "C" int gat_layer_attend_f32(const void* x, const void* adj, const void* s,
                                    const void* h, int ldh, void* out, int B, int G, int D,
                                    int TI, int CG, float slope, void* stream) {
  return attend(x, adj, s, h, ldh, out, B, G, D, TI, CG, slope, stream);
}

namespace {

// The fused step with x and out of type T (the plan and checks of
// gat_layer_fused_bf16 below).
template <typename T>
int fused(const void* x, const void* adj, const void* y, const void* k3, const void* a,
          void* out, int B, int G, int D, int Dp, int R, int TIb, int TJb, int CG, float slope,
          void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || Dp < D || Dp % 8 || (R != 2 && R != 4) || TIb <= 0 ||
      TJb <= 0 || CG <= 0 ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(k3) |
       reinterpret_cast<uintptr_t>(a)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = gs::tile_threads(R, TIb, TJb, 8), BI = R * TIb;
  const size_t smem = sizeof(float) * fused_smem_floats(G, Dp, R, TIb, TJb, CG);
  const dim3 grid((G + BI - 1) / BI, B);
  if (threads > gs::kMaxThreads || ((BI + 3) / 4) * CG > threads || grid.y > 65535 ||
      smem > size_t(g_max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // four elements of x and out at a time where they are aligned to four
  const bool v4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(out)) % (4 * sizeof(T)) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* px = static_cast<const T*>(x);
  const unsigned char* pa = static_cast<const unsigned char*>(adj);
  const float *py = static_cast<const float*>(y), *pk = static_cast<const float*>(k3),
              *pv = static_cast<const float*>(a);
  T* po = static_cast<T*>(out);
#define DIGAT_FUSED(RR, V)                                                                   \
  gat_layer_fused_kernel<T, RR, V><<<grid, threads, smem, st>>>(px, pa, py, Dp, pk, pv, po, G, \
                                                                D, TIb, TJb, CG, slope)
  if (R == 4) {
    if (v4) DIGAT_FUSED(4, true);
    else DIGAT_FUSED(4, false);
  } else {
    if (v4) DIGAT_FUSED(2, true);
    else DIGAT_FUSED(2, false);
  }
#undef DIGAT_FUSED
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16-activation instance's step 2: out [B, G, D] (bf16) from x [B, G,
// D] (bf16), adj [B, G, G] (bytes), y [B G, 3Dp], k3 [B, Dp] and a [Dp]
// (fp32, 16-byte aligned, zero from D to Dp; Dp a multiple of 8). The plan
// (gat_layer.py::fused_plan): rows ti + q TIb and columns tj + r TJb of a
// tile a thread (q, r < R), R TIb rows a block, and 4 CG features a slice
// of the aggregation, (R TIb / 4 rounded up) x CG threads at most.
extern "C" int gat_layer_fused_bf16(const void* x, const void* adj, const void* y,
                                    const void* k3, const void* a, void* out, int B, int G, int D,
                                    int Dp, int R, int TIb, int TJb, int CG, float slope,
                                    void* stream) {
  return fused<__nv_bfloat16>(x, adj, y, k3, a, out, B, G, D, Dp, R, TIb, TJb, CG, slope,
                              stream);
}

// The bf16-weight instance's step 2: the same with x and out fp32 (out not
// rounded).
extern "C" int gat_layer_fused_f32(const void* x, const void* adj, const void* y,
                                   const void* k3, const void* a, void* out, int B, int G, int D,
                                   int Dp, int R, int TIb, int TJb, int CG, float slope,
                                   void* stream) {
  return fused<float>(x, adj, y, k3, a, out, B, G, D, Dp, R, TIb, TJb, CG, slope, stream);
}
