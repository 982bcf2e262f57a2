// Pieces of the MSA encoder that its forward (msa_encoder.cu, kernel A) and
// its recompute backward (msa_encoder_bwd.cu, kernel A') both run: the word
// dropout of the embedded titles, the attention forward of one (title, head)
// unit, and the pool's masked softmax over a title's positions. Each file
// that includes this header gets its own copy of these kernels (an unnamed
// namespace); the arithmetic is one text, so kernel A computes its q|k|v, h
// and pool logits in the same order as kernel A' recomputes them.
//
// The attention unit: a block of 4 warps per (title, head), in place of one
// 8-warp block per title that held the title's whole q|k|v (228 KB of shared
// memory: 8 warps an SM). The unit's q, k, v rows sit in shared memory as
// float4 rows kv_stride(dk) floats apart, so that 8 lanes reading 8 rows hit
// 8 bank quads and all lanes reading one row is a broadcast; the scores P as
// [32][33]. Each thread owns a query row i (its lane) and 8 keys (its warp's)
// for the scores, and a row and up to 4 column groups of 4 for the output.
// The softmax combines the four warps' maxima and sums over their keys of a
// row. Rows come in by cp.async. About 24 KB of shared memory and at most 64
// registers a thread at dk 25: 8 or more blocks, 32 or more warps an SM.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kL = 32;  // title length: one warp lane per position
constexpr int kThreads = 256;
constexpr int kAttnThreads = 128;  // a unit: 4 warps
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kKeys = kL / kAttnWarps;  // keys per warp in the row pass
constexpr int kMaxGroups = 4;          // float4 column groups per thread: dk <= 64
constexpr int kMaxDk = 4 * kAttnWarps * kMaxGroups;
constexpr int kPS = kL + 1;            // row stride of P and dS
constexpr int kMaxA4 = 4;              // pool float4 columns per lane: A <= 512
constexpr float kMaskFill = -1e9f;
// |pre-activation| <= kReluTol * sum_j p_ij |v_jc| marks a unit for kernel
// A''s msa_attn_relu_fix_kernel: 5 to 10 times the largest gap between the
// tensor-core q|k|v path and fp32 CUDA-core arithmetic, relative to that sum,
// over the training step's 115M pre-activations (about 1e-6)
constexpr float kReluTol = 1e-5f;

using digat::warp_max;
using digat::warp_sum;

// Row stride of a unit's rows in shared memory: dk padded to a float4, plus
// 4 where that is a multiple of 8 floats, so that float4 rows are an odd
// number of bank quads apart.
__host__ __device__ inline int kv_stride(int dk) {
  const int w = (dk + 3) & ~3;
  return (w / 4) % 2 ? w : w + 4;
}

// Floats of shared memory of msa_attn_fwd_kernel<kTrain>: q, k, v, P, the
// four warps' maxima and sums of each row, and for kernel A' the unit's dp.
__host__ __device__ inline int attn_fwd_floats(int dk, bool train) {
  return 3 * kL * kv_stride(dk) + kL * kPS + (train ? kv_stride(dk) : 0) + 2 * kAttnWarps * kL;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float a, const float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// rows [32][RS] of a unit's dk columns of a row-major [*, ld] array, zero
// past dk, by cp.async: the caller commits and waits
__device__ __forceinline__ void load_unit(float* dst, const float* src, size_t ld, int dk,
                                          int RS) {
  const int W = (dk + 3) & ~3;
  for (int e = threadIdx.x; e < kL * W; e += kAttnThreads) {
    const int i = e / W, c = e - i * W;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i * RS + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(c < dk ? src + i * ld + c : src), "r"(c < dk ? 4 : 0));
  }
}

__device__ __forceinline__ void load_unit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

__device__ __forceinline__ void store_unit(float* dst, const float* src, size_t ld, int dk,
                                           int RS) {
  for (int e = threadIdx.x; e < kL * dk; e += kAttnThreads) {
    const int i = e / dk, c = e - i * dk;
    dst[i * ld + c] = src[i * RS + c];
  }
}

// blocks of kThreads for a grid-stride loop over `work` items
inline int grid_1d(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return int(b < 132 * 32 ? (b > 0 ? b : 1) : 132 * 32);
}

// ---------------------------------------------------------------------------
// Word dropout on [n, per_title] rows, in place allowed: element (title r,
// flat f) takes word f % 4 of the Philox block at counter (f / 4, r) under
// (seed, site) (philox.cuh); kept ones are scaled by drop_scale
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dropout_apply_kernel(const float* in, float* out, long long n, int per_title, uint32_t thresh,
                     float drop_scale, uint32_t seed, uint32_t site) {
  const int groups = per_title / 4;
  const long long total = n * groups;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long r = t / groups;
    const digat::Philox4 d =
        digat::dropout_draws(uint32_t(r), uint32_t(t - r * groups), seed, site);
    out4[t] = digat::dropout_value4(in4[t], d, thresh, drop_scale);
  }
}

// ---------------------------------------------------------------------------
// Attention forward of a unit (title n, head hd): h = relu(P v) with
// P = softmax(q k^T scale), written to the unit's columns of h (row stride
// ldh). kTrain (kernel A') also writes the rows' log-sum-exp and the head's
// part of dalpha = dp . h, and lists the unit where a pre-activation lies
// within kReluTol of 0; kernel A needs none of these, and may pass h = the
// q columns of qkv (ldh = 3D): a unit reads its q, k, v before it writes h.
// ---------------------------------------------------------------------------
template <bool kTrain>
__global__ void __launch_bounds__(kAttnThreads, 8)
msa_attn_fwd_kernel(const float* qkv,                 // [N*L, 3D]
                    const float* __restrict__ dp,     // kTrain: [N, D]
                    float* h, int ldh,                // [N*L, ldh] out
                    float* __restrict__ lse,          // kTrain: [N, heads, L] out
                    float* __restrict__ dap,          // kTrain: [N, heads, L] out: dp . h per head
                    int* __restrict__ unsure,         // kTrain: [1 + N * heads]: count, then units
                    int heads, int dk, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RS = kv_stride(dk), G = (dk + 3) / 4, D = heads * dk;
  const int n = blockIdx.x / heads, hd = blockIdx.x - n * heads;
  const int i = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* qs = smem;  // q, then h
  float* ks = qs + kL * RS;
  float* vs = ks + kL * RS;
  float* P = vs + kL * RS;  // [kL][kPS]
  float* red_m = P + kL * kPS;  // [kAttnWarps][kL]: each warp's max and sum of a row
  float* red_l = red_m + kAttnWarps * kL;
  float* dps = red_l + kAttnWarps * kL;  // kTrain: the unit's dp
  const float* rows = qkv + (size_t)n * kL * 3 * D + hd * dk;
  load_unit(qs, rows, 3 * D, dk, RS);
  load_unit(ks, rows + D, 3 * D, dk, RS);
  load_unit(vs, rows + 2 * D, 3 * D, dk, RS);
  if (kTrain) {
    for (int c = threadIdx.x; c < RS; c += kAttnThreads)
      dps[c] = c < dk ? dp[(size_t)n * D + hd * dk + c] : 0.f;
  }
  load_unit_wait();

  // scores of row i against this warp's keys; the softmax from each warp's
  // max and sum over its keys
  {
    const float4* q4 = reinterpret_cast<const float4*>(qs + i * RS);
    float s[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) s[jj] = 0.f;
    for (int gi = 0; gi < G; ++gi) {
      const float4 qv = q4[gi];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
        s[jj] = dot4(qv, reinterpret_cast<const float4*>(ks + (w * kKeys + jj) * RS)[gi], s[jj]);
    }
    float mw = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      s[jj] *= scale;
      mw = fmaxf(mw, s[jj]);
    }
    float lw = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) lw += expf(s[jj] - mw);
    red_m[w * kL + i] = mw;
    red_l[w * kL + i] = lw;
    __syncthreads();
    float m = red_m[i];
#pragma unroll
    for (int ww = 1; ww < kAttnWarps; ++ww) m = fmaxf(m, red_m[ww * kL + i]);
    float l = 0.f;
#pragma unroll
    for (int ww = 0; ww < kAttnWarps; ++ww) l += red_l[ww * kL + i] * expf(red_m[ww * kL + i] - m);
    const float inv = 1.f / l;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) P[i * kPS + w * kKeys + jj] = expf(s[jj] - m) * inv;
    if (kTrain && w == 0) lse[((size_t)n * heads + hd) * kL + i] = m + logf(l);
  }
  __syncthreads();
  // h = relu(P v) for this thread's column groups, over q's rows; for
  // kernel A', a pre-activation within kReluTol of sum_j p_ij |v_jc| of 0
  // marks the unit
  int near0 = 0;
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    if (gi < G) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f), a = o;
#pragma unroll 8
      for (int j = 0; j < kL; ++j) {
        const float pj = P[i * kPS + j];
        const float4 vj = reinterpret_cast<const float4*>(vs + j * RS)[gi];
        axpy4(pj, vj, o);
        if (kTrain) axpy4(pj, make_float4(fabsf(vj.x), fabsf(vj.y), fabsf(vj.z), fabsf(vj.w)), a);
      }
      if (kTrain) {
        const float ov[4] = {o.x, o.y, o.z, o.w}, av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) near0 |= 4 * gi + c < dk && fabsf(ov[c]) <= kReluTol * av[c];
      }
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f);
      o.w = fmaxf(o.w, 0.f);
      reinterpret_cast<float4*>(qs + i * RS)[gi] = o;
    }
  }
  if (kTrain) {
    // the list's order varies from run to run; each unit's fix does not
    if (__syncthreads_or(near0) && threadIdx.x == 0) unsure[1 + atomicAdd(unsure, 1)] = blockIdx.x;
    if (w == 0) {
      float da = 0.f;
      for (int gi = 0; gi < G; ++gi)
        da = dot4(reinterpret_cast<const float4*>(qs + i * RS)[gi],
                  reinterpret_cast<const float4*>(dps)[gi], da);
      dap[((size_t)n * heads + hd) * kL + i] = da;
    }
  } else {
    __syncthreads();
  }
  store_unit(h + (size_t)n * kL * ldh + hd * dk, qs, ldh, dk, RS);
}

// The pool's softmax weight of position `lane` (row = n * 32 + lane) of a
// title: its logit summed from `parts` per-warp-column parts in order, the
// -1e9 fill where the mask is off (an all-pad title gives uniform weights).
__device__ __forceinline__ float pool_alpha(const float* __restrict__ lgpart, int parts,
                                            size_t M, size_t row, bool keep) {
  float lg = 0.f;
  for (int q = 0; q < parts; ++q) lg += lgpart[q * M + row];
  const float logit = keep ? lg : kMaskFill;
  const float mx = warp_max(logit);
  const float e = expf(logit - mx);
  return e / warp_sum(e);
}

}  // namespace
