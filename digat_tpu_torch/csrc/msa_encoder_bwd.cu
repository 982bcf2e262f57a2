// Fused MSA news encoder, recompute backward, fp32 and bf16, for sm_90a
// (kernel A').
//
// Replaces the TPU kernel digat_tpu/ops/pallas/msa_encoder.py
// (_encoder_bwd -> _call(is_bwd) -> _bwd_kernel, and _bwd_kernel_v2, which
// computes the same gradients). Given the embedded titles x [N, L, Din], the
// title mask, the weights and dp = dLoss/dpooled [N, D], it recomputes the
// forward of kernel A and returns dx [N, L, Din] and the gradients of W_Q,
// b_Q, W_K, W_V, b_V, affine1 (W1, b1) and affine2 (v). The word-dropout mask
// is drawn again from the same Philox bits as the forward (philox.cuh) and
// applied to x on the way in and to dx on the way out; it never reaches
// device memory.
//
// What bounds it on an H100: the six matrix products. Over M = N L rows
// they cost 2 M Din 3D FLOP three times (the Q|K|V recompute, dx, dW) and
// 2 M D A three times (the pool's u = h W1^T, dh = dpre W1, dW1): at
// N 8,960 (M 286,720), Din 300, D 400, A 256 that is 0.80 TFLOP, against
// about 0.06 TFLOP of attention and a few GB of scratch traffic.
//
// Design. A chain of launches on the caller's stream, with scratch in
// device memory that the wrapper allocates:
//   1. xd = dropout(x) (Philox, per title), written to scratch;
//   2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv]                  (tc_gemm, kBias)
//   3. msa_attn_fwd_kernel, a block per (title, head): P = softmax(q k^T
//      scale), h = relu(P v), its log-sum-exp per row, and the head's part
//      of dalpha = dp . h per position; it marks a unit where a
//      pre-activation lies within rounding of 0 (below);
//  3b. msa_attn_relu_fix_kernel: those units' h again in float64;
//   4. u = tanh(h W1^T + b1) with its v-product per warp column (tc_gemm,
//      kPool);
//   5. msa_pool_kernel, a warp per title: the masked softmax over the 32
//      positions and its backward; dpre = dlg v (1 - u^2) in place of u, and
//      the title's parts of db1 and dv;
//   6. dW1 = dpre^T h                                      (tc_gemm, split)
//   7. dO = (alpha dp + dpre W1) * (h > 0)                 (tc_gemm, kDh)
//   8. msa_attn_bwd_kernel, a block per (title, head): the attention
//      backward, dq|dk|dv written over the title's q|k|v, and their column
//      sums (the bias gradients' parts);
//   9. dx = dqkv [Wq;Wk;Wv] with the dropout mask        (tc_gemm, kDrop)
//  10. dWqkv = dqkv^T xd                                   (tc_gemm, split)
//  11. the column sums of the parts, in title order.
// The products run on the tensor cores at 3xTF32 (tc_gemm.cuh), each
// 32-deep k-tile's sums added to the running sums rounding to nearest
// (kRN), as kernels A and B do, at tiles 96 wide (kRN's second set of
// accumulators fits the registers there): fp32-class accuracy, within
// about 1e-6 of the exact value relative to the sums' terms; step 2 is
// then the same product, tiles and bits as kernel A's q|k|v. The one place
// where that is not enough is the ReLU after the attention: a
// pre-activation within rounding of 0 takes the ReLU's gradient (0 or the
// whole upstream term) from the sign that rounding gives it, and at N 8,960
// a dozen of the 115M pre-activations fall on the other side of 0 in one
// fp32 order than in another, enough to move dx by 3e-3 where the gate is
// 1e-4 (scripts/msa_bwd_precision.py). So the forward marks each unit with a
// pre-activation within kReluTol of its scale (about 3,500 of 143,360 units
// at N 8,960), and step 3b recomputes just those units' q|k|v, scores and h
// in float64 from the fp32 inputs: the ReLU's side is then that of the
// exact value. The plain version runs its attention in float64 too, so both
// take the same side whatever order either sums in. (Until this kernel's
// products took kRN, step 3b recomputed in fp32 in the order of cuBLAS's
// fp32 SGEMM, and rested on cuBLAS summing over Din in order; at titles of
// L 48 cuBLAS's batched attention products sum otherwise, and flips got
// through. kRN alone could not lift that: it makes the tensor-core sum as
// close to the exact value as an fp32 sum in order is, not the same
// number.) The remaining assumption is kReluTol itself: the tensor-core
// pre-activation must lie within it of the float64 value (measured 3.6e-7
// to 4.1e-7 of the scale, 25 times under it). The weight
// gradients split the M rows into fixed slices, each slice's partial
// written apart and summed in slice order; every other reduction also sums
// in a fixed order, with no atomics, so the result is the same bits on
// every run.
//
// bf16 (msa_encoder_bwd_bf16: x and the weight matrices bf16, as at
// compute_dtype bfloat16): step 1 rounds each kept x / (1 - rate) to bf16
// once, as kernel A's bf16 instance does. The six products run on wgmma
// fed by the TMA (tc_wgmma.cuh), every operand bf16. Step 2 is one pass of
// exact bf16 products summed in fp32 (kRN over 64-deep tiles: not kernel
// A's q|k|v bits, which sums 32-deep tiles on mma.sync; both lie within
// about 1e-7 of the float64 value relative to the sum's terms, far inside
// kReluTol; scripts/msa_bwd_precision.py --bf16 measures the gap). Each
// fp32 operand (h, dpre, dq|dk|dv) is split into three bf16 planes
// (hi, mid, lo): h by split3_kernel after step 3b, dpre and dq|dk|dv by
// steps 5 and 8 themselves (their kPlanes instances write the planes in
// place of fp32), so steps 4, 7, 9 and 10 take three bf16 passes against
// the exact bf16 weight or x, and step 6 (dpre^T h, both fp32) six; the
// weight gradients (steps 6, 10) read both operands MN-major, and steps 7
// and 9 read W1 and Wqkv as K-major copies (relayout_kernel, a few hundred
// KB; x too, where its rows are not 16 bytes apart). Step 9 stores dx in
// bf16, rounded once to nearest even after the dropout mask. The weight
// gradients come out fp32. The ReLU fix reads the bf16 x and W and
// recomputes in float64 as before.
//
// The attention kernels: a block of 4 warps per (title, head), a unit. The
// forward (msa_attn_fwd_kernel<true>), the word dropout and the pool's
// softmax live in msa_title.cuh, shared with kernel A. The backward keeps
// the unit's q, k, v and do rows in shared memory as the forward does, the
// scores P and their gradient dS as [32][33]; each thread owns a query row i
// (its lane) and 8 keys (its warp's) for the scores, a row and up to 4
// column groups of 4 for dq, and a key and the same groups for dk and dv.
// It takes t_i = sum_j p_ij dp_ij as 4 per-warp parts summed in order, and
// p_ij = exp(s_ij - lse_i) from the forward's log-sum-exp.
//
// Title length. Titles of L = 1 to 32 positions take the first L of the 32
// slots of a unit and of a pool warp (msa_title.cuh); every array in
// global memory keeps L rows a title (M = N L), and p_ij and dS_ij are 0
// past L. Titles of 33 to 128 positions, and heads of dk 65 to 128, run the
// long unit (msa_title.cuh: a thread per position, the head in 32-column
// chunks) for steps 3, 3b and 8: msa_attn_fwd_long_kernel<true>,
// msa_attn_relu_fix_long_kernel (the unit's q|k|v in `fixbuf`, a slice of
// the scratch per block, the scores in shared memory) and
// msa_attn_bwd_long_kernel (P and dS in shared memory, summed chunk by
// chunk); past L 32 the pool's backward is msa_pool_long_kernel (a lane
// per position and its 32-apart neighbours). The products are the same.
// At an odd L, M is often not a multiple of 4: the products that read an
// M-major operand (the weight gradients, steps 6 and 10) sum over M,
// as their K, row by row, which tc::gemm takes at any K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "msa_title.cuh"
#include "tc_gemm.cuh"
#include "tc_wgmma.cuh"

namespace {

constexpr int kFixBlocks = 2 * 132;  // blocks walking the list of units to fix
constexpr int kFixThreads = 256;  // a block of the ReLU fix
constexpr int kFixWarps = kFixThreads / 32;
constexpr int kFixRows = kMaxDk / kFixWarps;  // W rows of q, k or v per warp in the fix
constexpr int kRowsPerSplit = 4096;    // rows of one slice of a weight gradient
constexpr int kColRows = 256;          // rows of one slice of a column sum over titles
// tile width of the fp32 instance's six products: kRN's second set of
// accumulators fits in the registers at 96 columns a block (tc_gemm.cuh)
constexpr int kBNq = 96, kBNp = 96, kBN = 96;
// the bf16 instance's wgmma products (tc_wgmma.cuh): a consumer's tile
// width (u and the weight gradients wg::kN 128; q|k|v, dO and dx wg::kNx
// 152, dx with the consumers side by side, one tile of 304 over Din 300;
// q|k|v is kernel A's bf16 instance's product too) and the blocks a weight
// gradient's slices aim at (four an SM)
constexpr int kWgN = digat::wg::kN, kWgNx = digat::wg::kNx;
constexpr int kWgBlocks = 4 * 132;

namespace tc = digat::tc;
namespace wg = digat::wg;

__host__ __device__ inline int attn_bwd_floats(int dk) {
  return 4 * kL * kv_stride(dk) + 2 * kL * kPS + kAttnWarps * kL;
}

// out[i] = sum over s (in order) of part[s * n + i]
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long n, int splits) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// part[z][c] = sum of A[r][c] over the z-th slice of rows
__global__ void colsum_kernel(const float* __restrict__ A, int M, int N, int rows_per_split,
                              float* __restrict__ part) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * rows_per_split, r1 = min(M, r0 + rows_per_split);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += A[(size_t)r * N + c];
  part[(size_t)blockIdx.y * N + c] = s;
}

using wg::ld8;
using wg::relayout_kernel;
using wg::split3_kernel;
using wg::store3;
using wg::store3x4;

// blocks of kThreads for `work` threads
inline unsigned blocks_for(long long work) { return unsigned((work + kThreads - 1) / kThreads); }

// ---------------------------------------------------------------------------
// The ReLU of a unit that msa_attn_fwd_kernel marked: its h again in
// float64 from the fp32 inputs (q|k|v summed over Din, then the bias; the
// scores over dk times 1 / sqrt(dk); the softmax; P v over the keys), so
// that a pre-activation within rounding of 0 falls on the side of its
// float64 value, the side the plain version takes too (it runs the
// attention in float64). Both sums are then the exact value to 1e-16 of the
// terms, whatever order either takes.
// ---------------------------------------------------------------------------
// x rows sit kx_stride(Din) floats apart: an odd number of float4s, so that
// 8 lanes reading 8 rows as float4 hit 8 bank quads; 32 rows whatever L,
// zero past L
__host__ __device__ inline int kx_stride(int Din) { return (Din / 4) % 2 ? Din : Din + 4; }

// floats of the short fix's shared memory: x rows and W rows (fp32), then
// q|k|v and the scores (float64, two floats each)
__host__ __device__ inline int relu_fix_floats(int Din, int dk) {
  return kL * kx_stride(Din) + dk * Din + 2 * (3 * kL * (dk + 1) + kL * kPS);
}

__device__ __forceinline__ double warp_max_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Blocks walk the list of marked units. The title's x rows and, in turn,
// the dk rows of Wq, Wk and Wv of the unit's head sit in shared memory; lane
// i owns position i and warp w the columns c = w, w + 8, ..., each summed
// in one pass over Din (the x row and the W row as float4) in float64.
template <int kFixedL, typename T>
__global__ void __launch_bounds__(kFixThreads)
msa_attn_relu_fix_kernel(const T* __restrict__ xin,        // [N*L, Din]
                         const T* __restrict__ wqkv,       // [3D, Din]
                         const float* __restrict__ bqkv,   // [3D]
                         const int* __restrict__ unsure,   // count, then units
                         float* __restrict__ h,            // [N*L, D]: the unit's rows again
                         int title_len, int Din, int heads, int dk) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  const int L = kFixedL > 0 ? kFixedL : title_len;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = heads * dk, XS = kx_stride(Din), TS = dk + 1, D4 = Din / 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const double dscale = 1.0 / sqrt(static_cast<double>(dk));
  float* xs = smem;             // [kL][XS]
  float* ws = xs + kL * XS;     // [dk][Din]: the head's rows of Wq, Wk or Wv
  double* t = reinterpret_cast<double*>(ws + dk * Din);  // [3][kL][TS]: q, k, v
  double* S = t + 3 * kL * TS;  // [kL][kPS]
  const int count = unsure[0];
  for (int u = blockIdx.x; u < count; u += gridDim.x) {
    const int unit = unsure[1 + u];
    const int n = unit / heads, hd = unit - n * heads;
    const T* xrows = xin + (size_t)n * L * Din;
    for (int e = threadIdx.x; e < kL * D4; e += kFixThreads) {
      const int i = e / D4;
      reinterpret_cast<float4*>(xs + i * XS)[e - i * D4] =
          kFull || i < L ? digat::load4(xrows + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float4* x4 = reinterpret_cast<const float4*>(xs + lane * XS);
    for (int which = 0; which < 3; ++which) {  // the head's q, k, v columns
      const T* wb = wqkv + ((size_t)which * D + hd * dk) * Din;
      for (int e = threadIdx.x; e < dk * D4; e += kFixThreads)
        reinterpret_cast<float4*>(ws)[e] = digat::load4(wb + 4 * e);
      __syncthreads();
      double acc[kFixRows];
#pragma unroll
      for (int m = 0; m < kFixRows; ++m) acc[m] = 0.0;
      for (int k4 = 0; k4 < D4; ++k4) {
        const float4 x = x4[k4];
#pragma unroll
        for (int m = 0; m < kFixRows; ++m) {
          const int c = w + kFixWarps * m;
          if (c < dk) {
            const float4 wv = reinterpret_cast<const float4*>(ws + c * Din)[k4];
            double a = acc[m];
            a = fma(double(x.x), double(wv.x), a);
            a = fma(double(x.y), double(wv.y), a);
            a = fma(double(x.z), double(wv.z), a);
            acc[m] = fma(double(x.w), double(wv.w), a);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kFixRows; ++m) {
        const int c = w + kFixWarps * m;
        if (c < dk)
          t[(which * kL + lane) * TS + c] = acc[m] + double(bqkv[which * D + hd * dk + c]);
      }
      __syncthreads();  // ws read for the last time
    }
    const double* q = t;
    const double* kk = t + kL * TS;
    const double* v = t + 2 * kL * TS;
    for (int e = threadIdx.x; e < kL * kL; e += kFixThreads) {
      const int i = e >> 5, j = e & 31;
      double s = 0.0;
      for (int c = 0; c < dk; ++c) s = fma(q[i * TS + c], kk[j * TS + c], s);
      S[i * kPS + j] = kFull || j < L ? s * dscale : -INFINITY;
    }
    __syncthreads();
    for (int i = w; i < L; i += kFixWarps) {
      const double s = S[i * kPS + lane];
      const double p = exp(s - warp_max_d(s));
      S[i * kPS + lane] = p / warp_sum_d(p);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L * dk; e += kFixThreads) {
      const int i = e / dk, c = e - i * dk;
      double o = 0.0;
      for (int j = 0; j < L; ++j) o = fma(S[i * kPS + j], v[j * TS + c], o);
      h[((size_t)n * L + i) * D + hd * dk + c] = static_cast<float>(fmax(o, 0.0));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The pool's softmax over a title's positions, its backward, and dpre
// ---------------------------------------------------------------------------
template <bool kPlanes = false>
__global__ void __launch_bounds__(kThreads)
msa_pool_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                int parts,
                const unsigned char* __restrict__ mask,  // [N, L]
                const float* __restrict__ dap,           // [N, heads, L]
                const float* __restrict__ v,             // [A]
                float* __restrict__ u,                   // [N*L, A]: u in, dpre out
                __nv_bfloat16* __restrict__ planes,      // kPlanes: dpre out
                float* __restrict__ alpha_out,           // [N*L]
                float* __restrict__ dv_part,             // [N, A]
                float* __restrict__ db1_part,            // [N, A]
                int N, int L, int heads, int A) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  const bool present = lane < L;
  const size_t M = (size_t)N * L, row = (size_t)n * L + lane;
  const bool keep = present && mask[row] != 0;
  const float alpha = pool_alpha(lgpart, parts, M, row, present, keep);
  float da = 0.f;
  if (present)
    for (int hd = 0; hd < heads; ++hd) da += dap[((size_t)n * heads + hd) * L + lane];
  const float s = warp_sum(alpha * da);
  const float dlg = keep ? (da - s) * alpha : 0.f;  // a masked logit passes no gradient
  if (present) alpha_out[row] = alpha;

  const int A4 = A / 4;
  float4 vv[kMaxA4], dva[kMaxA4], dba[kMaxA4];
#pragma unroll
  for (int r = 0; r < kMaxA4; ++r) {
    const int a = lane + 32 * r;
    vv[r] = a < A4 ? reinterpret_cast<const float4*>(v)[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    dva[r] = dba[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4* u4 = reinterpret_cast<float4*>(u + (size_t)n * L * A);
  for (int l = 0; l < L; ++l) {
    const float g = __shfl_sync(0xffffffffu, dlg, l);
#pragma unroll
    for (int r = 0; r < kMaxA4; ++r) {
      const int a = lane + 32 * r;
      if (a < A4) {
        const float4 x = u4[l * A4 + a];
        float4 z;
        z.x = g * vv[r].x * (1.f - x.x * x.x);
        z.y = g * vv[r].y * (1.f - x.y * x.y);
        z.z = g * vv[r].z * (1.f - x.z * x.z);
        z.w = g * vv[r].w * (1.f - x.w * x.w);
        axpy4(g, x, dva[r]);
        dba[r].x += z.x;
        dba[r].y += z.y;
        dba[r].z += z.z;
        dba[r].w += z.w;
        if (kPlanes)
          store3x4(planes + ((size_t)n * L + l) * ld8(A) + 4 * a, (size_t)N * L * ld8(A), z);
        else
          u4[l * A4 + a] = z;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxA4; ++r) {
    const int a = lane + 32 * r;
    if (a < A4) {
      reinterpret_cast<float4*>(dv_part + (size_t)n * A)[a] = dva[r];
      reinterpret_cast<float4*>(db1_part + (size_t)n * A)[a] = dba[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Attention backward of a unit: dq|dk|dv over q|k|v, and their column sums
// ---------------------------------------------------------------------------
// kPlanes (the bf16 instance): dq|dk|dv go out as the three bf16 planes of
// the wgmma products (`planes`, rows ld8(3D) apart, M rows a plane) in
// place of their fp32 values.
template <int kFixedL, bool kPlanes = false>
__global__ void __launch_bounds__(kAttnThreads, 8)
msa_attn_bwd_kernel(float* __restrict__ qkv,          // [N*L, 3D]: q|k|v in, dq|dk|dv out
                    const float* __restrict__ dO,     // [N*L, D]
                    const float* __restrict__ lse,    // [N, heads, L]
                    float* __restrict__ dbias_part,   // [N, 3D] out
                    __nv_bfloat16* __restrict__ planes,  // kPlanes: [3][N*L][ld8(3D)] out
                    int title_len, int heads, int dk, float scale) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  const int L = kFixedL > 0 ? kFixedL : title_len;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RS = kv_stride(dk), G = (dk + 3) / 4, D = heads * dk;
  const int n = blockIdx.x / heads, hd = blockIdx.x - n * heads;
  const int i = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* qs = smem;
  float* ks = qs + kL * RS;
  float* vs = ks + kL * RS;
  float* dos = vs + kL * RS;
  float* P = dos + kL * RS;  // [kL][kPS]
  float* S = P + kL * kPS;   // [kL][kPS]: dP, then dS
  float* red = S + kL * kPS;  // [kAttnWarps][kL]
  float* rows = qkv + (size_t)n * L * 3 * D + hd * dk;
  load_unit(qs, rows, 3 * D, dk, RS, L);
  load_unit(ks, rows + D, 3 * D, dk, RS, L);
  load_unit(vs, rows + 2 * D, 3 * D, dk, RS, L);
  load_unit(dos, dO + (size_t)n * L * D + hd * dk, D, dk, RS, L);
  const float lse_i = kFull || i < L ? lse[((size_t)n * heads + hd) * L + i] : 0.f;
  load_unit_wait();

  // row pass: p_ij and dp_ij for this warp's keys, t_i's part; p_ij is 0
  // for a row or key past L
  {
    const float4* q4 = reinterpret_cast<const float4*>(qs + i * RS);
    const float4* o4 = reinterpret_cast<const float4*>(dos + i * RS);
    float s[kKeys], d[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) s[jj] = d[jj] = 0.f;
    for (int gi = 0; gi < G; ++gi) {
      const float4 qv = q4[gi], ov = o4[gi];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int j = w * kKeys + jj;
        s[jj] = dot4(qv, reinterpret_cast<const float4*>(ks + j * RS)[gi], s[jj]);
        d[jj] = dot4(ov, reinterpret_cast<const float4*>(vs + j * RS)[gi], d[jj]);
      }
    }
    float t = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float pv =
          kFull || (i < L && w * kKeys + jj < L) ? expf(s[jj] * scale - lse_i) : 0.f;
      t = fmaf(pv, d[jj], t);
      P[i * kPS + w * kKeys + jj] = pv;
      S[i * kPS + w * kKeys + jj] = d[jj];
    }
    red[w * kL + i] = t;
  }
  __syncthreads();
  {
    float t = red[i];
#pragma unroll
    for (int ww = 1; ww < kAttnWarps; ++ww) t += red[ww * kL + i];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int e = i * kPS + w * kKeys + jj;
      S[e] = P[e] * (S[e] - t) * scale;
    }
  }
  __syncthreads();
  // dq_i = sum_j dS_ij k_j for this thread's column groups
  float4 acc[kMaxGroups];
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < G) {
#pragma unroll 8
      for (int j = 0; j < L; ++j)
        axpy4(S[i * kPS + j], reinterpret_cast<const float4*>(ks + j * RS)[gi], acc[r]);
    }
  }
  __syncthreads();  // k read for the last time
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    if (gi < G) reinterpret_cast<float4*>(ks + i * RS)[gi] = acc[r];
  }
  // key pass, lane = key j: dk_j = sum_i dS_ij q_i, dv_j = sum_i p_ij do_i
  float4 dkv[kMaxGroups], dvv[kMaxGroups];
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    dkv[r] = dvv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < G) {
#pragma unroll 4
      for (int ii = 0; ii < L; ++ii) {
        axpy4(S[ii * kPS + i], reinterpret_cast<const float4*>(qs + ii * RS)[gi], dkv[r]);
        axpy4(P[ii * kPS + i], reinterpret_cast<const float4*>(dos + ii * RS)[gi], dvv[r]);
      }
    }
  }
  __syncthreads();  // q read for the last time
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    if (gi < G) {
      reinterpret_cast<float4*>(qs + i * RS)[gi] = dkv[r];
      reinterpret_cast<float4*>(vs + i * RS)[gi] = dvv[r];
    }
  }
  __syncthreads();
  if (kPlanes) {  // dq, dk, dv as three bf16 terms each: a warp a row, a lane a column
    const size_t ld = ld8(3 * D), plane = size_t(gridDim.x / heads) * L * ld;
    __nv_bfloat16* out = planes + (size_t)n * L * ld + hd * dk;
    for (int which = 0; which < 3; ++which) {
      const float* tile = which == 0 ? ks : (which == 1 ? qs : vs);
      for (int ii = w; ii < L; ii += kAttnWarps)
        for (int c = i; c < dk; c += 32)
          store3(out + ii * ld + which * D + c, plane, tile[ii * RS + c]);
    }
  } else {
    store_unit(rows, ks, 3 * D, dk, RS, L);      // dq
    store_unit(rows + D, qs, 3 * D, dk, RS, L);  // dk
    store_unit(rows + 2 * D, vs, 3 * D, dk, RS, L);  // dv
  }
  // the unit's column sums of dq, dk, dv over its L rows, in row order
  for (int e = threadIdx.x; e < 3 * dk; e += kAttnThreads) {
    const int which = e / dk, c = e - which * dk;
    const float* tile = which == 0 ? ks : (which == 1 ? qs : vs);
    float s = 0.f;
    for (int r = 0; r < L; ++r) s += tile[r * RS + c];
    dbias_part[(size_t)n * 3 * D + which * D + hd * dk + c] = s;
  }
}

// ---------------------------------------------------------------------------
// The long unit (msa_title.cuh: titles of 33 to 128, or dk 65 to 128): the
// ReLU fix, the pool's backward and the attention backward
// ---------------------------------------------------------------------------
constexpr int kFixLongBlocks = 132;  // blocks walking the list of long units to fix

// floats of the long fix's q|k|v of one unit (float64, two floats each), in
// device memory (one a block)
__host__ __device__ inline size_t relu_fix_long_unit_floats(int L, int dk) {
  return 2 * 3 * size_t(L) * dk;
}

// The long ReLU fix, in float64 as the short one: a unit's q|k|v, each
// element summed over Din and then its bias, written to the block's own
// [3][L][dk] of `fixbuf`; its scores into S [L][long_ls(L)] (shared memory,
// float64); a warp per row for the softmax; P v over the keys.
template <typename T>
__global__ void __launch_bounds__(kFixThreads)
msa_attn_relu_fix_long_kernel(const T* __restrict__ xin,        // [N*L, Din]
                              const T* __restrict__ wqkv,       // [3D, Din]
                              const float* __restrict__ bqkv,   // [3D]
                              const int* __restrict__ unsure,   // count, then units
                              float* __restrict__ h,            // [N*L, D]
                              float* __restrict__ fixbuf,       // [gridDim.x][3][L][dk] doubles
                              int L, int Din, int heads, int dk) {
  extern __shared__ float4 smem4[];
  double* S = reinterpret_cast<double*>(smem4);  // [L][LS]
  const int D = heads * dk, LS = long_ls(L), LD = L * dk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const double dscale = 1.0 / sqrt(static_cast<double>(dk));
  double* t = reinterpret_cast<double*>(fixbuf + blockIdx.x *
                                        relu_fix_long_unit_floats(L, dk));  // q, k, v [L][dk]
  const int count = unsure[0];
  for (int u = blockIdx.x; u < count; u += gridDim.x) {
    const int unit = unsure[1 + u];
    const int n = unit / heads, hd = unit - n * heads;
    for (int e = threadIdx.x; e < 3 * LD; e += kFixThreads) {
      const int which = e / LD, r = e - which * LD, i = r / dk, c = r - i * dk;
      const T* x4 = xin + ((size_t)n * L + i) * Din;
      const T* w4 = wqkv + ((size_t)which * D + hd * dk + c) * Din;
      double a = 0.0;
      for (int k4 = 0; k4 < Din / 4; ++k4) {
        const float4 x = digat::load4(x4 + 4 * k4), wv = digat::load4(w4 + 4 * k4);
        a = fma(double(x.x), double(wv.x), a);
        a = fma(double(x.y), double(wv.y), a);
        a = fma(double(x.z), double(wv.z), a);
        a = fma(double(x.w), double(wv.w), a);
      }
      t[e] = a + double(bqkv[which * D + hd * dk + c]);
    }
    __syncthreads();
    const double* q = t;
    const double* kk = t + LD;
    const double* v = t + 2 * LD;
    for (int e = threadIdx.x; e < L * L; e += kFixThreads) {
      const int i = e / L, j = e - i * L;
      double s = 0.0;
      for (int c = 0; c < dk; ++c) s = fma(q[i * dk + c], kk[j * dk + c], s);
      S[i * LS + j] = s * dscale;
    }
    __syncthreads();
    for (int i = w; i < L; i += kFixWarps) {
      double m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmax(m, S[i * LS + j]);
      m = warp_max_d(m);
      double z = 0.0;
      for (int j = lane; j < L; j += 32) z += exp(S[i * LS + j] - m);
      const double inv = 1.0 / warp_sum_d(z);
      for (int j = lane; j < L; j += 32) S[i * LS + j] = exp(S[i * LS + j] - m) * inv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < LD; e += kFixThreads) {
      const int i = e / dk, c = e - i * dk;
      double o = 0.0;
      for (int j = 0; j < L; ++j) o = fma(S[i * LS + j], v[j * dk + c], o);
      h[((size_t)n * L + i) * D + hd * dk + c] = static_cast<float>(fmax(o, 0.0));
    }
    __syncthreads();  // t and S read for the last time
  }
}

// The pool's softmax, its backward and dpre for a title of 33 to 128
// positions: msa_pool_kernel with lane l taking positions l, l + 32, ...
template <bool kPlanes = false>
__global__ void __launch_bounds__(kThreads)
msa_pool_long_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                     int parts,
                     const unsigned char* __restrict__ mask,  // [N, L]
                     const float* __restrict__ dap,           // [N, heads, L]
                     const float* __restrict__ v,             // [A]
                     float* __restrict__ u,                   // [N*L, A]: u in, dpre out
                     __nv_bfloat16* __restrict__ planes,      // kPlanes: dpre out
                     float* __restrict__ alpha_out,           // [N*L]
                     float* __restrict__ dv_part,             // [N, A]
                     float* __restrict__ db1_part,            // [N, A]
                     int N, int L, int heads, int A) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  const size_t M = (size_t)N * L;
  float al[kLongWarps], dlg[kLongWarps], da[kLongWarps];
  pool_alpha_long(lgpart, parts, M, mask, n, L, lane, al);
  float sd = 0.f;
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) {
    const int l = lane + 32 * r;
    da[r] = 0.f;
    if (l < L)
      for (int hd = 0; hd < heads; ++hd) da[r] += dap[((size_t)n * heads + hd) * L + l];
    sd += al[r] * da[r];
  }
  const float s = warp_sum(sd);
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) {
    const int l = lane + 32 * r;
    const bool keep = l < L && mask[(size_t)n * L + l] != 0;
    dlg[r] = keep ? (da[r] - s) * al[r] : 0.f;  // a masked logit passes no gradient
    if (l < L) alpha_out[(size_t)n * L + l] = al[r];
  }
  const int A4 = A / 4;
  float4 vv[kMaxA4], dva[kMaxA4], dba[kMaxA4];
#pragma unroll
  for (int r = 0; r < kMaxA4; ++r) {
    const int a = lane + 32 * r;
    vv[r] = a < A4 ? reinterpret_cast<const float4*>(v)[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    dva[r] = dba[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4* u4 = reinterpret_cast<float4*>(u + (size_t)n * L * A);
  for (int l = 0; l < L; ++l) {
    const float g = lane_value(dlg, l);
#pragma unroll
    for (int r = 0; r < kMaxA4; ++r) {
      const int a = lane + 32 * r;
      if (a < A4) {
        const float4 x = u4[l * A4 + a];
        float4 z;
        z.x = g * vv[r].x * (1.f - x.x * x.x);
        z.y = g * vv[r].y * (1.f - x.y * x.y);
        z.z = g * vv[r].z * (1.f - x.z * x.z);
        z.w = g * vv[r].w * (1.f - x.w * x.w);
        axpy4(g, x, dva[r]);
        dba[r].x += z.x;
        dba[r].y += z.y;
        dba[r].z += z.z;
        dba[r].w += z.w;
        if (kPlanes)
          store3x4(planes + ((size_t)n * L + l) * ld8(A) + 4 * a, (size_t)N * L * ld8(A), z);
        else
          u4[l * A4 + a] = z;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxA4; ++r) {
    const int a = lane + 32 * r;
    if (a < A4) {
      reinterpret_cast<float4*>(dv_part + (size_t)n * A)[a] = dva[r];
      reinterpret_cast<float4*>(db1_part + (size_t)n * A)[a] = dba[r];
    }
  }
}

// Floats of shared memory of msa_attn_bwd_long_kernel: P and dS, four chunks.
__host__ __device__ inline int attn_bwd_long_floats(int L) {
  return 2 * L * long_ls(L) + 4 * L * kChunkS;
}

// Attention backward of a long unit: dq|dk|dv over q|k|v and their column
// sums, as msa_attn_bwd_kernel. P = exp(s scale - lse) and dP = do v^T are
// summed chunk by chunk into shared memory, the columns in order; then
// t_i = sum_j p_ij dp_ij over the keys in order and dS = P (dP - t) scale;
// then, chunk by chunk, thread i forms row i of dq (over the keys in order)
// and key i's rows of dk and dv (over the rows in order), which go over the
// chunk's columns of q, k and v once every thread has read them.
template <bool kPlanes = false>
__global__ void __launch_bounds__(kLongL)
msa_attn_bwd_long_kernel(float* __restrict__ qkv,          // [N*L, 3D]: q|k|v in, dq|dk|dv out
                         const float* __restrict__ dO,     // [N*L, D]
                         const float* __restrict__ lse,    // [N, heads, L]
                         float* __restrict__ dbias_part,   // [N, 3D] out
                         __nv_bfloat16* __restrict__ planes,  // kPlanes: as msa_attn_bwd_kernel
                         int L, int heads, int dk, float scale) {
  extern __shared__ float4 smem4[];
  const int LS = long_ls(L), D = heads * dk;
  float* P = reinterpret_cast<float*>(smem4);  // [L][LS]: s, then p
  float* G = P + L * LS;                       // [L][LS]: dp, then ds
  float* cq = G + L * LS;                      // [L][kChunkS] chunks of q, k, v, do
  float* ck = cq + L * kChunkS;
  float* cv = ck + L * kChunkS;
  float* cd = cv + L * kChunkS;
  const int n = blockIdx.x / heads, hd = blockIdx.x - n * heads;
  const int i = threadIdx.x;
  const bool row = i < L;
  float* rows = qkv + (size_t)n * L * 3 * D + hd * dk;
  const float* drows = dO + (size_t)n * L * D + hd * dk;
  for (int c0 = 0; c0 < dk; c0 += kChunk) {
    const int w = min(kChunk, dk - c0);
    load_chunk(cq, rows + c0, 3 * D, L, w);
    load_chunk(ck, rows + D + c0, 3 * D, L, w);
    load_chunk(cv, rows + 2 * D + c0, 3 * D, L, w);
    load_chunk(cd, drows + c0, D, L, w);
    __syncthreads();
    if (row) {
      float qr[kChunk], dr[kChunk];
      chunk_row(qr, cq, i);
      chunk_row(dr, cd, i);
      for (int j = 0; j < L; ++j) {
        P[i * LS + j] = chunk_dot(qr, ck, j, c0 ? P[i * LS + j] : 0.f);
        G[i * LS + j] = chunk_dot(dr, cv, j, c0 ? G[i * LS + j] : 0.f);
      }
    }
    __syncthreads();
  }
  if (row) {
    const float lse_i = lse[((size_t)n * heads + hd) * L + i];
    float t = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = expf(P[i * LS + j] * scale - lse_i);
      P[i * LS + j] = p;
      t = fmaf(p, G[i * LS + j], t);
    }
    for (int j = 0; j < L; ++j) G[i * LS + j] = P[i * LS + j] * (G[i * LS + j] - t) * scale;
  }
  for (int c0 = 0; c0 < dk; c0 += kChunk) {
    const int w = min(kChunk, dk - c0);
    __syncthreads();  // P and dS complete; the last chunk's outputs stored
    load_chunk(cq, rows + c0, 3 * D, L, w);
    load_chunk(ck, rows + D + c0, 3 * D, L, w);
    load_chunk(cd, drows + c0, D, L, w);
    __syncthreads();
    float gq[kChunk], gk[kChunk], gv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) gq[c] = gk[c] = gv[c] = 0.f;
    if (row) {
      for (int j = 0; j < L; ++j) chunk_axpy(gq, G[i * LS + j], ck, j);
      for (int r = 0; r < L; ++r) {
        chunk_axpy(gk, G[r * LS + i], cq, r);
        chunk_axpy(gv, P[r * LS + i], cd, r);
      }
    }
    __syncthreads();  // the chunks read for the last time
    if (row) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        cq[i * kChunkS + c] = gq[c];
        ck[i * kChunkS + c] = gk[c];
        cv[i * kChunkS + c] = gv[c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * L * kChunk; e += blockDim.x) {
      const int which = e / (L * kChunk), r = e - which * L * kChunk;
      const int ii = r / kChunk, c = r - ii * kChunk;
      const float* tile = which == 0 ? cq : (which == 1 ? ck : cv);
      if (c >= w) continue;
      if (kPlanes) {
        const size_t ld = ld8(3 * D), plane = size_t(gridDim.x / heads) * L * ld;
        store3(planes + ((size_t)n * L + ii) * ld + which * D + hd * dk + c0 + c, plane,
               tile[ii * kChunkS + c]);
      } else {
        rows[(size_t)ii * 3 * D + which * D + c0 + c] = tile[ii * kChunkS + c];
      }
    }
    // the unit's column sums of dq, dk, dv over its L rows, in row order
    for (int e = threadIdx.x; e < 3 * w; e += blockDim.x) {
      const int which = e / w, c = e - which * w;
      const float* tile = which == 0 ? cq : (which == 1 ? ck : cv);
      float sum = 0.f;
      for (int r = 0; r < L; ++r) sum += tile[r * kChunkS + c];
      dbias_part[(size_t)n * 3 * D + which * D + hd * dk + c0 + c] = sum;
    }
  }
}

int g_max_smem = 0;  // opt-in shared memory per block, set by msa_encoder_bwd_init

// Whether step 3b runs the long fix (q|k|v in device memory): for the long
// unit, and for a short unit whose x and W rows do not fit the short fix's
// block (Din 900 at dk 25, Din 600 at dk 64).
bool long_fix(int L, int Din, int dk) {
  return !short_unit(L, dk) || sizeof(float) * relu_fix_floats(Din, dk) > size_t(g_max_smem);
}

inline int splits_of(long long rows, int per) { return int((rows + per - 1) / per); }

// floats of each scratch array, in the order they sit in the scratch buffer;
// the bf16 instance's wgmma operands last (bf16, two a float; 0 for fp32):
// the planes of h, dpre and dq|dk|dv, x with 16-byte rows (where Din % 8),
// and the weights W1, W1^T, Wqkv and Wqkv^T with 16-byte rows
struct Scratch {
  size_t xd, qkv, h, dO, u, lgpart, lse, dap, alpha, unsure, dbp, dvp, db1p, part, cpart, fix;
  size_t h3 = 0, dpre3 = 0, dqkv3 = 0, xpad = 0, w1p = 0, w1t = 0, wqkvp = 0, wqkvt = 0;
  size_t total() const {
    return xd + qkv + h + dO + u + lgpart + lse + dap + alpha + unsure + dbp + dvp + db1p +
           part + cpart + fix + h3 + dpre3 + dqkv3 + xpad + w1p + w1t + wqkvp + wqkvt;
  }
  // every array starts 16-byte aligned (float4, tensor-core loads, the TMA)
  void align() {
    for (size_t* f : {&xd, &qkv, &h, &dO, &u, &lgpart, &lse, &dap, &alpha, &unsure, &dbp, &dvp,
                      &db1p, &part, &cpart, &fix, &h3, &dpre3, &dqkv3, &xpad, &w1p, &w1t,
                      &wqkvp, &wqkvt})
      *f = (*f + 3) & ~size_t(3);
  }
};

// floats holding n bf16 elements
inline size_t bf16_floats(long long n) { return size_t((n + 1) / 2); }

Scratch scratch_of(int N, int L, int Din, int heads, int D, int A, bool bf16) {
  const int dk = D / heads;
  const long long M = (long long)N * L;
  const long long S = splits_of(M, kRowsPerSplit), Sn = splits_of(N, kColRows);
  Scratch s;
  s.xd = size_t(M) * Din;
  s.qkv = size_t(M) * 3 * D;
  s.h = size_t(M) * D;
  s.dO = size_t(M) * D;
  s.u = size_t(M) * A;  // u, then dpre
  s.lgpart = size_t(tc::pool_parts<kBNp>(A)) * M;
  s.lse = size_t(M) * heads;
  s.dap = size_t(M) * heads;
  s.alpha = size_t(M);
  s.unsure = size_t(N) * heads + 1;  // ints: a count, then units
  s.dbp = size_t(N) * 3 * D;
  s.dvp = size_t(N) * A;
  s.db1p = size_t(N) * A;
  const long long p1 = S * 3LL * D * Din, p2 = S * (long long)A * D;
  s.part = size_t(p1 > p2 ? p1 : p2);
  s.cpart = size_t(Sn * (3LL * D > A ? 3LL * D : A));
  s.fix = long_fix(L, Din, dk) ? kFixLongBlocks * relu_fix_long_unit_floats(L, dk) : 0;
  if (bf16) {
    s.h3 = bf16_floats(3 * M * ld8(D));
    s.dpre3 = bf16_floats(3 * M * ld8(A));
    s.dqkv3 = bf16_floats(3 * M * ld8(3 * D));
    s.xpad = Din % 8 ? bf16_floats(M * ld8(Din)) : 0;
    s.w1p = bf16_floats((long long)A * ld8(D));
    s.w1t = bf16_floats((long long)D * ld8(A));
    s.wqkvp = bf16_floats(3LL * D * ld8(Din));
    s.wqkvt = bf16_floats((long long)Din * ld8(3 * D));
  }
  s.align();
  return s;
}

// K rows of one slice of a wgmma weight gradient over `tiles` output tiles:
// about kWgBlocks blocks in all, a multiple of the k-tile, and at least
// kRowsPerSplit (so no more slices than the fp32 products' `part` holds).
inline int wg_rows_per_split(long long K, long long tiles, int KT) {
  const long long slices = (kWgBlocks + tiles - 1) / tiles;
  const long long per = ((K + slices - 1) / slices + KT - 1) / KT * KT;
  return int(per > kRowsPerSplit ? per : kRowsPerSplit);
}

// out[0:C] = column sums of a [R, C] array of per-title parts (fixed slices
// of kColRows rows, then summed in slice order)
cudaError_t colsum(cudaStream_t st, const float* A, int R, int C, float* part, float* out) {
  const int S = splits_of(R, kColRows);
  colsum_kernel<<<dim3((C + kThreads - 1) / kThreads, S), kThreads, 0, st>>>(A, R, C, kColRows,
                                                                             part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_splits_kernel<<<grid_1d(C), kThreads, 0, st>>>(part, out, C, S);
  return cudaGetLastError();
}

// out = the slices of `part` ([S, n]) summed in order
cudaError_t sum_splits(cudaStream_t st, const float* part, float* out, long long n, int S) {
  sum_splits_kernel<<<grid_1d(n), kThreads, 0, st>>>(part, out, n, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int msa_encoder_bwd_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int L : {32, 16, 0})
    if (e == cudaSuccess)
      e = with_title_length(L, [](auto fixed) {
        constexpr int kF = decltype(fixed)::value;
        cudaError_t err = cudaFuncSetAttribute(msa_attn_relu_fix_kernel<kF, float>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               g_max_smem);
        if (err != cudaSuccess) return err;
        return cudaFuncSetAttribute(msa_attn_relu_fix_kernel<kF, __nv_bfloat16>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
      });
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_relu_fix_long_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_relu_fix_long_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_fwd_long_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_bwd_long_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_bwd_long_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  if (e == cudaSuccess) e = tc::init<true, true, kBNq, tc::kBias, true>();
  if (e == cudaSuccess) e = tc::init<true, true, kBNp, tc::kPool, true>();
  if (e == cudaSuccess) e = tc::init<false, false, kBN, tc::kStore, true>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kDh, true>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kDrop, true>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kStore, true>();
  // the bf16 instance's products on wgmma: q|k|v one bf16 pass, the rest
  // three or six, dx stored bf16
  using bf16 = __nv_bfloat16;
  if (e == cudaSuccess) e = wg::init<kWgNx, 64, true, true, 1, 1, tc::kBias>();
  if (e == cudaSuccess) e = wg::init<kWgN, 64, true, true, 3, 1, tc::kPool>();
  if (e == cudaSuccess) e = wg::init<kWgN, 32, false, false, 3, 3, tc::kStore>();
  if (e == cudaSuccess) e = wg::init<kWgNx, 64, true, true, 3, 1, tc::kDh>();
  if (e == cudaSuccess) e = wg::init<kWgNx, 64, true, true, 3, 1, tc::kDrop, bf16, true>();
  if (e == cudaSuccess) e = wg::init<kWgNx, 64, true, true, 3, 1, tc::kStore, bf16, true>();
  if (e == cudaSuccess) e = wg::init<kWgN, 64, false, false, 3, 1, tc::kStore>();
  return static_cast<int>(e);
}

// Floats of scratch that msa_encoder_bwd_f32 (bf16 0) or msa_encoder_bwd_bf16
// (bf16 1) needs (0 if the shapes are not taken).
extern "C" long long msa_encoder_bwd_scratch_floats(int N, int L, int Din, int heads, int dk,
                                                    int A, int bf16) {
  if (N <= 0 || L <= 0 || L > kLongL || Din <= 0 || heads <= 0 || dk <= 0 || dk > kLongMaxDk ||
      A <= 0)
    return 0;
  return (long long)scratch_of(N, L, Din, heads, heads * dk, A, bf16 != 0).total();
}

namespace {

// The backward for x, dx and the weight matrices of type T (float or bf16).
template <typename T>
cudaError_t backward(const T* fx, const void* mask, const T* fw, const float* bqkv,
                     const T* fw1, const float* b1, const float* v, const float* fdp, T* fdx,
                     float* dwqkv, float* dbqkv, float* dw1, float* db1, float* dv,
                     float* scratch, int N, int L, int Din, int heads, int dk, int A,
                     float scale, unsigned thresh, float drop_scale, unsigned seed,
                     unsigned site, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int D = heads * dk;
  const bool short_path = short_unit(L, dk);
  if (N <= 0 || L <= 0 || L > kLongL || Din <= 0 || Din % 4 != 0 || D % 4 != 0 ||
      dk > kLongMaxDk || A <= 0 || A % 4 != 0 || A > 128 * kMaxA4 ||
      sizeof(float) * attn_bwd_long_floats(kLongL) > size_t(g_max_smem)) {
    return cudaErrorInvalidValue;
  }
  const Scratch sz = scratch_of(N, L, Din, heads, D, A, kBf16);
  T* xd = reinterpret_cast<T*>(scratch);
  float* qkv = scratch + sz.xd;
  float* h = qkv + sz.qkv;
  float* dO = h + sz.h;
  float* u = dO + sz.dO;
  float* lgpart = u + sz.u;
  float* lse = lgpart + sz.lgpart;
  float* dap = lse + sz.lse;
  float* alpha = dap + sz.dap;
  int* unsure = reinterpret_cast<int*>(alpha + sz.alpha);
  float* dbp = alpha + sz.alpha + sz.unsure;
  float* dvp = dbp + sz.dbp;
  float* db1p = dvp + sz.dvp;
  float* part = db1p + sz.db1p;
  float* cpart = part + sz.part;
  float* fixbuf = cpart + sz.cpart;
  // the bf16 instance's planes and copies (tc_wgmma.cuh operands)
  using bf16 = __nv_bfloat16;
  bf16* h3 = reinterpret_cast<bf16*>(fixbuf + sz.fix);
  bf16* dpre3 = reinterpret_cast<bf16*>(fixbuf + sz.fix + sz.h3);
  bf16* dqkv3 = reinterpret_cast<bf16*>(fixbuf + sz.fix + sz.h3 + sz.dpre3);
  bf16* xpad = reinterpret_cast<bf16*>(fixbuf + sz.fix + sz.h3 + sz.dpre3 + sz.dqkv3);
  bf16* w1p = xpad + 2 * sz.xpad;
  bf16* w1t = w1p + 2 * sz.w1p;
  bf16* wqkvp = w1t + 2 * sz.w1t;
  bf16* wqkvt = wqkvp + 2 * sz.wqkvp;
  const int M = N * L;
  const int S = splits_of(M, kRowsPerSplit);
  cudaError_t e;
  auto args = [](const void* A_, const void* B_, void* C_, int M_, int N_, int K_, int lda,
                 int ldb, int ldc, int kps) {
    tc::Args a{};
    a.A = A_;
    a.B = B_;
    a.C = C_;
    a.M = M_;
    a.N = N_;
    a.K = K_;
    a.lda = lda;
    a.ldb = ldb;
    a.ldc = ldc;
    a.k_per_split = kps;
    return a;
  };

  // 1. xd = dropout(x); without dropout xd is x itself
  const T* xin = fx;
  if (thresh) {
    dropout_apply_kernel<T><<<grid_1d((long long)M * Din / 4), kThreads, 0, st>>>(
        fx, xd, N, L * Din, Din, Din, thresh, drop_scale, seed, site);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    xin = xd;
  }
  // the wgmma products' operands: x (or xd) with 16-byte rows where Din %
  // 8, W1 and Wqkv as they are and transposed, each with 16-byte rows
  wg::Operand xb{};
  if constexpr (kBf16) {
    xb = wg::Operand{xin, M, Din, Din, (long long)M * Din};
    if (Din % 8) {
      relayout_kernel<false><<<blocks_for((long long)M * Din / 4), kThreads, 0, st>>>(
          xin, Din, M, Din, xpad);
      xb = wg::Operand{xpad, M, Din, ld8(Din), (long long)M * ld8(Din)};
    }
    relayout_kernel<false><<<blocks_for((long long)A * D / 4), kThreads, 0, st>>>(fw1, D, A, D,
                                                                                  w1p);
    relayout_kernel<true><<<blocks_for((long long)A * D), kThreads, 0, st>>>(fw1, D, D, A, w1t);
    relayout_kernel<false><<<blocks_for(3LL * D * Din / 4), kThreads, 0, st>>>(fw, Din, 3 * D,
                                                                              Din, wqkvp);
    relayout_kernel<true><<<blocks_for(3LL * D * Din), kThreads, 0, st>>>(fw, Din, Din, 3 * D,
                                                                          wqkvt);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  auto plane_op = [&](const bf16* planes, int cols) {
    return wg::Operand{planes, M, cols, ld8(cols), (long long)M * ld8(cols)};
  };
  // 2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv] (bf16: one pass on wgmma)
  tc::Args a = args(xin, fw, qkv, M, 3 * D, Din, Din, Din, 3 * D, Din);
  a.bias = bqkv;
  if constexpr (kBf16) {
    e = wg::gemm<kWgNx, 64, true, true, 1, 1, tc::kBias>(
        st, xb, wg::Operand{wqkvp, 3 * D, Din, ld8(Din), 3LL * D * ld8(Din)}, a);
  } else {
    e = tc::gemm<true, true, kBNq, tc::kBias, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 3. attention forward per unit, with the list of units to fix; 3b. the
  // marked units' ReLU again in float64
  if ((e = cudaMemsetAsync(unsure, 0, sizeof(int), st)) != cudaSuccess) return e;
  const bool fix_long = long_fix(L, Din, dk);
  if (!short_path) {
    msa_attn_fwd_long_kernel<true>
        <<<N * heads, long_threads(L), sizeof(float) * attn_fwd_long_floats(L), st>>>(
            qkv, fdp, h, D, lse, dap, unsure, L, heads, dk, scale);
    e = cudaGetLastError();
  } else e = with_title_length(L, [&](auto fixed) {
    constexpr int kF = decltype(fixed)::value;
    msa_attn_fwd_kernel<true, kF>
        <<<N * heads, kAttnThreads, sizeof(float) * attn_fwd_floats(dk, true), st>>>(
            qkv, fdp, h, D, lse, dap, unsure, L, heads, dk, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || fix_long) return err;
    msa_attn_relu_fix_kernel<kF, T>
        <<<kFixBlocks, kFixThreads, sizeof(float) * relu_fix_floats(Din, dk), st>>>(
            xin, fw, bqkv, unsure, h, L, Din, heads, dk);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  if (fix_long) {
    msa_attn_relu_fix_long_kernel<T><<<kFixLongBlocks, kFixThreads,
                                       sizeof(double) * L * long_ls(L), st>>>(
        xin, fw, bqkv, unsure, h, fixbuf, L, Din, heads, dk);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // 4. u = tanh(h W1^T + b1), lgpart = its v-product per warp column (per
  // block column on wgmma)
  a = args(h, fw1, u, M, A, D, D, D, A, D);
  a.bias = b1;
  a.v = v;
  a.lgpart = lgpart;
  int parts = tc::pool_parts<kBNp>(A);
  if constexpr (kBf16) {
    split3_kernel<<<blocks_for((long long)M * D / 4), kThreads, 0, st>>>(h, D, h3, M, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = wg::gemm<kWgN, 64, true, true, 3, 1, tc::kPool>(
        st, plane_op(h3, D), wg::Operand{w1p, A, D, ld8(D), (long long)A * ld8(D)}, a);
    parts = (A + kWgN - 1) / kWgN;
  } else {
    e = tc::gemm<true, true, kBNp, tc::kPool, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 5. the pool's softmax and its backward; dpre over u (bf16: as the
  // three planes of steps 6 and 7's operand, dpre3)
  (L > kL ? msa_pool_long_kernel<kBf16> : msa_pool_kernel<kBf16>)
      <<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
          lgpart, parts, static_cast<const unsigned char*>(mask), dap, v, u, dpre3, alpha, dvp,
          db1p, N, L, heads, A);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* dpre = u;
  // 6. dW1 = dpre^T h, split over rows
  int slices = S;
  if constexpr (kBf16) {
    const int per = wg_rows_per_split(M, (long long)((D + kWgN - 1) / kWgN) *
                                             ((A + wg::kBM - 1) / wg::kBM), 32);
    a = args(nullptr, nullptr, part, A, D, M, 0, 0, D, per);
    e = wg::gemm<kWgN, 32, false, false, 3, 3, tc::kStore>(st, plane_op(dpre3, A),
                                                             plane_op(h3, D), a);
    slices = splits_of(M, per);
  } else {
    a = args(dpre, h, part, A, D, M, A, D, D, kRowsPerSplit);
    e = tc::gemm<false, false, kBN, tc::kStore, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  if ((e = sum_splits(st, part, dw1, (long long)A * D, slices)) != cudaSuccess) return e;
  // 7. dO = (alpha dp + dpre W1) * (h > 0)
  a = args(dpre, fw1, dO, M, D, A, A, D, D, A);
  a.alpha = alpha;
  a.dp = fdp;
  a.h = h;
  a.title = L;
  if constexpr (kBf16) {
    e = wg::gemm<kWgNx, 64, true, true, 3, 1, tc::kDh>(
        st, plane_op(dpre3, A), wg::Operand{w1t, D, A, ld8(A), (long long)D * ld8(A)}, a);
  } else {
    e = tc::gemm<true, false, kBN, tc::kDh, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 8. attention backward per unit; dq|dk|dv over q|k|v (bf16: as the
  // three planes of steps 9 and 10's operand, dqkv3)
  if (!short_path) {
    msa_attn_bwd_long_kernel<kBf16><<<N * heads, long_threads(L),
                                      sizeof(float) * attn_bwd_long_floats(L), st>>>(
        qkv, dO, lse, dbp, dqkv3, L, heads, dk, scale);
    e = cudaGetLastError();
  } else e = with_title_length(L, [&](auto fixed) {
    msa_attn_bwd_kernel<decltype(fixed)::value, kBf16>
        <<<N * heads, kAttnThreads, sizeof(float) * attn_bwd_floats(dk), st>>>(
            qkv, dO, lse, dbp, dqkv3, L, heads, dk, scale);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  // 9. dx = dqkv [Wq;Wk;Wv], with the dropout mask (stored as T: bf16
  // rounded once, after the mask)
  a = args(qkv, fw, fdx, M, Din, 3 * D, 3 * D, Din, Din, 3 * D);
  if (thresh) {
    a.thresh = thresh;
    a.drop_scale = drop_scale;
    a.seed = seed;
    a.site = site;
    a.title = L;
  }
  if constexpr (kBf16) {
    const wg::Operand wt{wqkvt, Din, 3 * D, ld8(3 * D), (long long)Din * ld8(3 * D)};
    const wg::Operand dq = plane_op(dqkv3, 3 * D);
    e = thresh ? wg::gemm<kWgNx, 64, true, true, 3, 1, tc::kDrop, bf16, true>(st, dq, wt, a)
               : wg::gemm<kWgNx, 64, true, true, 3, 1, tc::kStore, bf16, true>(st, dq, wt, a);
  } else {
    e = thresh ? tc::gemm<true, false, kBN, tc::kDrop, true, T>(st, a)
               : tc::gemm<true, false, kBN, tc::kStore, true, T>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 10. dWqkv = dqkv^T xd, split over rows
  if constexpr (kBf16) {
    const int per = wg_rows_per_split(M, (long long)((Din + kWgN - 1) / kWgN) *
                                             ((3 * D + wg::kBM - 1) / wg::kBM), 64);
    a = args(nullptr, nullptr, part, 3 * D, Din, M, 0, 0, Din, per);
    e = wg::gemm<kWgN, 64, false, false, 3, 1, tc::kStore>(st, plane_op(dqkv3, 3 * D), xb, a);
    slices = splits_of(M, per);
  } else {
    a = args(qkv, xin, part, 3 * D, Din, M, 3 * D, Din, Din, kRowsPerSplit);
    e = tc::gemm<false, false, kBN, tc::kStore, true>(st, a);
    slices = S;
  }
  if (e != cudaSuccess) return e;
  if ((e = sum_splits(st, part, dwqkv, 3LL * D * Din, slices)) != cudaSuccess) return e;
  // 11. the bias and v gradients from the per-title parts
  if ((e = colsum(st, dbp, N, 3 * D, cpart, dbqkv)) != cudaSuccess) return e;
  if ((e = colsum(st, db1p, N, A, cpart, db1)) != cudaSuccess) return e;
  return colsum(st, dvp, N, A, cpart, dv);
}

}  // namespace

// x [N, L, Din]; wqkv [3D, Din] (Wq, Wk, Wv stacked, nn.Linear layout);
// bqkv [3D] ([bq | 0 | bv]); w1 [A, D]; outputs dx [N, L, Din], dwqkv
// [3D, Din], dbqkv [3D], dw1 [A, D], db1 [A], dv [A]. fp32 throughout.
extern "C" int msa_encoder_bwd_f32(const void* x, const void* mask, const void* wqkv,
                                   const void* bqkv, const void* w1, const void* b1,
                                   const void* v, const void* dp, void* dx, void* dwqkv,
                                   void* dbqkv, void* dw1, void* db1, void* dv, void* scratch,
                                   int N, int L, int Din, int heads, int dk, int A, float scale,
                                   unsigned thresh, float drop_scale, unsigned seed,
                                   unsigned site, void* stream) {
  return static_cast<int>(backward<float>(
      static_cast<const float*>(x), mask, static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(v),
      static_cast<const float*>(dp), static_cast<float*>(dx), static_cast<float*>(dwqkv),
      static_cast<float*>(dbqkv), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dv), static_cast<float*>(scratch), N, L, Din, heads, dk, A, scale,
      thresh, drop_scale, seed, site, static_cast<cudaStream_t>(stream)));
}

// The same with x, wqkv, w1 and dx bf16 (the vectors, dp, the weight
// gradients and the scratch fp32).
extern "C" int msa_encoder_bwd_bf16(const void* x, const void* mask, const void* wqkv,
                                    const void* bqkv, const void* w1, const void* b1,
                                    const void* v, const void* dp, void* dx, void* dwqkv,
                                    void* dbqkv, void* dw1, void* db1, void* dv, void* scratch,
                                    int N, int L, int Din, int heads, int dk, int A, float scale,
                                    unsigned thresh, float drop_scale, unsigned seed,
                                    unsigned site, void* stream) {
  using bf16 = __nv_bfloat16;
  return static_cast<int>(backward<bf16>(
      static_cast<const bf16*>(x), mask, static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(v),
      static_cast<const float*>(dp), static_cast<bf16*>(dx), static_cast<float*>(dwqkv),
      static_cast<float*>(dbqkv), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dv), static_cast<float*>(scratch), N, L, Din, heads, dk, A, scale,
      thresh, drop_scale, seed, site, static_cast<cudaStream_t>(stream)));
}
