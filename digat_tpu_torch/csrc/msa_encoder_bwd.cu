// Fused MSA news encoder, recompute backward, fp32, for sm_90a (kernel A').
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
//  3b. msa_attn_relu_fix_kernel: those units' h again in fp32 CUDA-core
//      order;
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
// The products run on the tensor cores at 3xTF32 (tc_gemm.cuh), which keeps
// fp32-class accuracy: within about 1e-6 of the exact value relative to
// the sums' terms. The one place where that is not enough is the ReLU after
// the attention: a pre-activation within rounding of 0 takes the ReLU's
// gradient (0 or the whole upstream term) from the sign that rounding gives
// it, and at N 8,960 a dozen of the 115M pre-activations fall on the other
// side of 0 than in fp32 arithmetic, enough to move dx by 3e-3 where the
// gate is 1e-4 (scripts/msa_bwd_precision.py). So the forward marks each
// unit with a pre-activation within kReluTol of its scale (about 3,500 of
// 143,360 units at N 8,960), and step 3b recomputes just those units'
// q|k|v, scores and h on the CUDA cores as an fp32 product summed over Din
// in order gives them; the ReLU's side is then that of fp32 CUDA-core
// arithmetic. That is what holds the kernel to its fp32 plain version
// within the gate at N 8,960, where the plain version itself is further
// from float64 than the gate (dx 4.0e-4, dwq 3.9e-3 against limits of 1e-4
// and 1e-3). It rests on an assumption about the plain version: that
// cuBLAS's fp32 SGEMM sums over Din in order, one thread an output, with no
// split over K, as step 3b does. A torch or cuBLAS that sums otherwise (a
// split-K SGEMM, or TF32 left on in the plain version, which
// runtime.exact_fp32 turns off) can put a pre-activation on the other side
// of 0 outside kReluTol and fail the gate with no fault in this kernel;
// scripts/msa_bwd_precision.py --seeds reads the margin. The weight
// gradients split the M rows into fixed slices, each slice's partial
// written apart and summed in slice order; every other reduction also sums
// in a fixed order, with no atomics, so the result is the same bits on
// every run.
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
// past L. At an odd L, M is often not a multiple of 4: the products that
// read an M-major operand (the weight gradients, steps 6 and 10) sum over M,
// as their K, row by row, which tc::gemm takes at any K.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "msa_title.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kFixBlocks = 2 * 132;  // blocks walking the list of units to fix
constexpr int kFixThreads = 256;  // a block of the ReLU fix
constexpr int kFixWarps = kFixThreads / 32;
constexpr int kFixRows = kMaxDk / kFixWarps;  // W rows of q, k or v per warp in the fix
constexpr int kRowsPerSplit = 4096;    // rows of one slice of a weight gradient
constexpr int kColRows = 256;          // rows of one slice of a column sum over titles
constexpr int kBNq = 128, kBNp = 128, kBN = 160;  // tile widths: Q|K|V, pool, the rest

namespace tc = digat::tc;

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

// ---------------------------------------------------------------------------
// The ReLU of a unit that msa_attn_fwd_kernel marked: its h again in the
// fp32 order of a CUDA-core product (q|k|v summed over Din in order from 0,
// then the bias; the scores over dk in order; the softmax's sum as a warp's
// butterfly; P v over the keys in order), so that a pre-activation within
// rounding of 0 falls on the side that fp32 arithmetic in that order puts it.
// ---------------------------------------------------------------------------
// x rows sit kx_stride(Din) floats apart: an odd number of float4s, so that
// 8 lanes reading 8 rows as float4 hit 8 bank quads; 32 rows whatever L,
// zero past L
__host__ __device__ inline int kx_stride(int Din) { return (Din / 4) % 2 ? Din : Din + 4; }

__host__ __device__ inline int relu_fix_floats(int Din, int dk) {
  return kL * kx_stride(Din) + dk * Din + 3 * kL * (dk + 1) + kL * kPS;
}

// Blocks walk the list of marked units. The title's x rows and, in turn,
// the dk rows of Wq, Wk and Wv of the unit's head sit in shared memory; lane
// i owns position i and warp w the columns c = w, w + 8, ..., each summed
// in one pass over Din (the x row and the W row as float4), in order from
// k = 0.
template <int kFixedL>
__global__ void __launch_bounds__(kFixThreads)
msa_attn_relu_fix_kernel(const float* __restrict__ xin,    // [N*L, Din]
                         const float* __restrict__ wqkv,   // [3D, Din]
                         const float* __restrict__ bqkv,   // [3D]
                         const int* __restrict__ unsure,   // count, then units
                         float* __restrict__ h,            // [N*L, D]: the unit's rows again
                         int title_len, int Din, int heads, int dk, float scale) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  const int L = kFixedL > 0 ? kFixedL : title_len;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = heads * dk, XS = kx_stride(Din), TS = dk + 1, D4 = Din / 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* xs = smem;             // [kL][XS]
  float* ws = xs + kL * XS;     // [dk][Din]: the head's rows of Wq, Wk or Wv
  float* t = ws + dk * Din;     // [3][kL][TS]: q, k, v
  float* S = t + 3 * kL * TS;   // [kL][kPS]
  const int count = unsure[0];
  for (int u = blockIdx.x; u < count; u += gridDim.x) {
    const int unit = unsure[1 + u];
    const int n = unit / heads, hd = unit - n * heads;
    const float4* xrows = reinterpret_cast<const float4*>(xin + (size_t)n * L * Din);
    for (int e = threadIdx.x; e < kL * D4; e += kFixThreads) {
      const int i = e / D4;
      reinterpret_cast<float4*>(xs + i * XS)[e - i * D4] =
          kFull || i < L ? xrows[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float4* x4 = reinterpret_cast<const float4*>(xs + lane * XS);
    for (int which = 0; which < 3; ++which) {  // the head's q, k, v columns
      const float4* wb =
          reinterpret_cast<const float4*>(wqkv + ((size_t)which * D + hd * dk) * Din);
      for (int e = threadIdx.x; e < dk * D4; e += kFixThreads)
        reinterpret_cast<float4*>(ws)[e] = __ldg(wb + e);
      __syncthreads();
      float acc[kFixRows];
#pragma unroll
      for (int m = 0; m < kFixRows; ++m) acc[m] = 0.f;
      for (int k4 = 0; k4 < D4; ++k4) {
        const float4 x = x4[k4];
#pragma unroll
        for (int m = 0; m < kFixRows; ++m) {
          const int c = w + kFixWarps * m;
          if (c < dk) {
            const float4 wv = reinterpret_cast<const float4*>(ws + c * Din)[k4];
            float a = acc[m];
            a = fmaf(x.x, wv.x, a);
            a = fmaf(x.y, wv.y, a);
            a = fmaf(x.z, wv.z, a);
            acc[m] = fmaf(x.w, wv.w, a);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kFixRows; ++m) {
        const int c = w + kFixWarps * m;
        if (c < dk) t[(which * kL + lane) * TS + c] = acc[m] + bqkv[which * D + hd * dk + c];
      }
      __syncthreads();  // ws read for the last time
    }
    const float* q = t;
    const float* kk = t + kL * TS;
    const float* v = t + 2 * kL * TS;
    for (int e = threadIdx.x; e < kL * kL; e += kFixThreads) {
      const int i = e >> 5, j = e & 31;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(q[i * TS + c], kk[j * TS + c], s);
      S[i * kPS + j] = kFull || j < L ? s * scale : -INFINITY;
    }
    __syncthreads();
    for (int i = w; i < L; i += kFixWarps) {
      const float s = S[i * kPS + lane];
      const float p = expf(s - warp_max(s));
      S[i * kPS + lane] = p / warp_sum(p);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L * dk; e += kFixThreads) {
      const int i = e / dk, c = e - i * dk;
      float o = 0.f;
      for (int j = 0; j < L; ++j) o = fmaf(S[i * kPS + j], v[j * TS + c], o);
      h[((size_t)n * L + i) * D + hd * dk + c] = fmaxf(o, 0.f);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The pool's softmax over a title's positions, its backward, and dpre
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
msa_pool_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                int parts,
                const unsigned char* __restrict__ mask,  // [N, L]
                const float* __restrict__ dap,           // [N, heads, L]
                const float* __restrict__ v,             // [A]
                float* __restrict__ u,                   // [N*L, A]: u in, dpre out
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
template <int kFixedL>
__global__ void __launch_bounds__(kAttnThreads, 8)
msa_attn_bwd_kernel(float* __restrict__ qkv,          // [N*L, 3D]: q|k|v in, dq|dk|dv out
                    const float* __restrict__ dO,     // [N*L, D]
                    const float* __restrict__ lse,    // [N, heads, L]
                    float* __restrict__ dbias_part,   // [N, 3D] out
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
  store_unit(rows, ks, 3 * D, dk, RS, L);      // dq
  store_unit(rows + D, qs, 3 * D, dk, RS, L);  // dk
  store_unit(rows + 2 * D, vs, 3 * D, dk, RS, L);  // dv
  // the unit's column sums of dq, dk, dv over its L rows, in row order
  for (int e = threadIdx.x; e < 3 * dk; e += kAttnThreads) {
    const int which = e / dk, c = e - which * dk;
    const float* tile = which == 0 ? ks : (which == 1 ? qs : vs);
    float s = 0.f;
    for (int r = 0; r < L; ++r) s += tile[r * RS + c];
    dbias_part[(size_t)n * 3 * D + which * D + hd * dk + c] = s;
  }
}

int g_max_smem = 0;  // opt-in shared memory per block, set by msa_encoder_bwd_init

inline int splits_of(long long rows, int per) { return int((rows + per - 1) / per); }

// floats of each scratch array, in the order they sit in the scratch buffer
struct Scratch {
  size_t xd, qkv, h, dO, u, lgpart, lse, dap, alpha, unsure, dbp, dvp, db1p, part, cpart;
  size_t total() const {
    return xd + qkv + h + dO + u + lgpart + lse + dap + alpha + unsure + dbp + dvp + db1p +
           part + cpart;
  }
  // every array starts 16-byte aligned (float4 and tensor-core loads)
  void align() {
    for (size_t* f : {&xd, &qkv, &h, &dO, &u, &lgpart, &lse, &dap, &alpha, &unsure, &dbp, &dvp,
                      &db1p, &part, &cpart})
      *f = (*f + 3) & ~size_t(3);
  }
};

Scratch scratch_of(int N, int L, int Din, int heads, int D, int A) {
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
  s.align();
  return s;
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
        return cudaFuncSetAttribute(msa_attn_relu_fix_kernel<decltype(fixed)::value>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
      });
  if (e == cudaSuccess) e = tc::init<true, true, kBNq, tc::kBias>();
  if (e == cudaSuccess) e = tc::init<true, true, kBNp, tc::kPool>();
  if (e == cudaSuccess) e = tc::init<false, false, kBN, tc::kStore>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kDh>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kDrop>();
  if (e == cudaSuccess) e = tc::init<true, false, kBN, tc::kStore>();
  return static_cast<int>(e);
}

// Floats of scratch that msa_encoder_bwd_f32 needs (0 if the shapes are not
// taken).
extern "C" long long msa_encoder_bwd_scratch_floats(int N, int L, int Din, int heads, int dk,
                                                    int A) {
  if (N <= 0 || L <= 0 || L > kL || Din <= 0 || heads <= 0 || dk <= 0 || A <= 0) return 0;
  return (long long)scratch_of(N, L, Din, heads, heads * dk, A).total();
}

// x [N, L, Din]; wqkv [3D, Din] (Wq, Wk, Wv stacked, nn.Linear layout);
// bqkv [3D] ([bq | 0 | bv]); w1 [A, D]; outputs dx [N, L, Din], dwqkv
// [3D, Din], dbqkv [3D], dw1 [A, D], db1 [A], dv [A].
extern "C" int msa_encoder_bwd_f32(const void* x, const void* mask, const void* wqkv,
                                   const void* bqkv, const void* w1, const void* b1,
                                   const void* v, const void* dp, void* dx, void* dwqkv,
                                   void* dbqkv, void* dw1, void* db1, void* dv, void* scratch,
                                   int N, int L, int Din, int heads, int dk, int A, float scale,
                                   unsigned thresh, float drop_scale, unsigned seed,
                                   unsigned site, void* stream) {
  const int D = heads * dk;
  if (N <= 0 || L <= 0 || L > kL || Din <= 0 || Din % 4 != 0 || D % 4 != 0 || dk > kMaxDk ||
      A <= 0 || A % 4 != 0 || A > 128 * kMaxA4 ||
      sizeof(float) * relu_fix_floats(Din, dk) > size_t(g_max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch sz = scratch_of(N, L, Din, heads, D, A);
  float* xd = static_cast<float*>(scratch);
  float* qkv = xd + sz.xd;
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
  const int M = N * L;
  const int S = splits_of(M, kRowsPerSplit);
  const float* fx = static_cast<const float*>(x);
  const float* fw = static_cast<const float*>(wqkv);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fdp = static_cast<const float*>(dp);
  float* fdx = static_cast<float*>(dx);
  cudaError_t e;
  auto args = [](const float* A_, const float* B_, float* C_, int M_, int N_, int K_, int lda,
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
  const float* xin = fx;
  if (thresh) {
    dropout_apply_kernel<<<grid_1d((long long)M * Din / 4), kThreads, 0, st>>>(
        fx, xd, N, L * Din, thresh, drop_scale, seed, site);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    xin = xd;
  }
  // 2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv]
  tc::Args a = args(xin, fw, qkv, M, 3 * D, Din, Din, Din, 3 * D, Din);
  a.bias = static_cast<const float*>(bqkv);
  if ((e = tc::gemm<true, true, kBNq, tc::kBias>(st, a)) != cudaSuccess) return int(e);
  // 3. attention forward per unit, with the list of units to fix; 3b. the
  // marked units' ReLU again in CUDA-core fp32 order
  if ((e = cudaMemsetAsync(unsure, 0, sizeof(int), st)) != cudaSuccess) return int(e);
  e = with_title_length(L, [&](auto fixed) {
    constexpr int kF = decltype(fixed)::value;
    msa_attn_fwd_kernel<true, kF>
        <<<N * heads, kAttnThreads, sizeof(float) * attn_fwd_floats(dk, true), st>>>(
            qkv, fdp, h, D, lse, dap, unsure, L, heads, dk, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    msa_attn_relu_fix_kernel<kF>
        <<<kFixBlocks, kFixThreads, sizeof(float) * relu_fix_floats(Din, dk), st>>>(
            xin, fw, static_cast<const float*>(bqkv), unsure, h, L, Din, heads, dk, scale);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  // 4. u = tanh(h W1^T + b1), lgpart = its v-product per warp column
  a = args(h, fw1, u, M, A, D, D, D, A, D);
  a.bias = static_cast<const float*>(b1);
  a.v = static_cast<const float*>(v);
  a.lgpart = lgpart;
  if ((e = tc::gemm<true, true, kBNp, tc::kPool>(st, a)) != cudaSuccess) return int(e);
  // 5. the pool's softmax and its backward; dpre over u
  msa_pool_kernel<<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      lgpart, tc::pool_parts<kBNp>(A), static_cast<const unsigned char*>(mask), dap,
      static_cast<const float*>(v), u, alpha, dvp, db1p, N, L, heads, A);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  float* dpre = u;
  // 6. dW1 = dpre^T h, split over rows
  a = args(dpre, h, part, A, D, M, A, D, D, kRowsPerSplit);
  if ((e = tc::gemm<false, false, kBN, tc::kStore>(st, a)) != cudaSuccess) return int(e);
  if ((e = sum_splits(st, part, static_cast<float*>(dw1), (long long)A * D, S)) != cudaSuccess)
    return static_cast<int>(e);
  // 7. dO = (alpha dp + dpre W1) * (h > 0)
  a = args(dpre, fw1, dO, M, D, A, A, D, D, A);
  a.alpha = alpha;
  a.dp = fdp;
  a.h = h;
  a.title = L;
  if ((e = tc::gemm<true, false, kBN, tc::kDh>(st, a)) != cudaSuccess) return int(e);
  // 8. attention backward per unit; dq|dk|dv over q|k|v
  e = with_title_length(L, [&](auto fixed) {
    msa_attn_bwd_kernel<decltype(fixed)::value>
        <<<N * heads, kAttnThreads, sizeof(float) * attn_bwd_floats(dk), st>>>(
            qkv, dO, lse, dbp, L, heads, dk, scale);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  // 9. dx = dqkv [Wq;Wk;Wv], with the dropout mask
  a = args(qkv, fw, fdx, M, Din, 3 * D, 3 * D, Din, Din, 3 * D);
  if (thresh) {
    a.thresh = thresh;
    a.drop_scale = drop_scale;
    a.seed = seed;
    a.site = site;
    a.title = L;
    e = tc::gemm<true, false, kBN, tc::kDrop>(st, a);
  } else {
    e = tc::gemm<true, false, kBN, tc::kStore>(st, a);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // 10. dWqkv = dqkv^T xd, split over rows
  a = args(qkv, xin, part, 3 * D, Din, M, 3 * D, Din, Din, kRowsPerSplit);
  if ((e = tc::gemm<false, false, kBN, tc::kStore>(st, a)) != cudaSuccess) return int(e);
  if ((e = sum_splits(st, part, static_cast<float*>(dwqkv), 3LL * D * Din, S)) != cudaSuccess)
    return static_cast<int>(e);
  // 11. the bias and v gradients from the per-title parts
  if ((e = colsum(st, dbp, N, 3 * D, cpart, static_cast<float*>(dbqkv))) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = colsum(st, db1p, N, A, cpart, static_cast<float*>(db1))) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(colsum(st, dvp, N, A, cpart, static_cast<float*>(dv)));
}
