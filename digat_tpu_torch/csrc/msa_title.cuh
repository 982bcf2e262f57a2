// Pieces of the MSA encoder that its forward (msa_encoder.cu, kernel A) and
// its recompute backward (msa_encoder_bwd.cu, kernel A') both run: the word
// dropout of the embedded titles, the attention forward of one (title, head)
// unit (the short unit, L <= 32 and dk <= 64, and the long one below), and
// the pool's masked softmax over a title's positions. Each file
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
// A title of L < 32 positions takes the first L of the 32 slots: rows past L
// are zero in shared memory and never written back, keys past L take score
// -inf (absent, not masked), and the pool gives slots past L weight 0. The
// attention kernels take L as a template constant kFixedL where the repo's
// configurations use it (32 and 16: loops of a known count, unrolled, and
// no test of a slot against L at 32) and at run time otherwise (kFixedL 0);
// with_title_length picks the instance.
// The softmax combines the four warps' maxima and sums over their keys of a
// row. Rows come in by cp.async. About 24 KB of shared memory and at most 64
// registers a thread at dk 25: 8 or more blocks, 32 or more warps an SM.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kL = 32;  // title slots: one warp lane per position; a title takes L <= kL
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
// A''s ReLU fix (msa_attn_relu_fix_kernel, which recomputes it in float64):
// about 25 times the largest gap between the tensor-core path and float64,
// relative to that sum, over the training step's 115M pre-activations
// (3.6e-7 to 4.1e-7, scripts/msa_bwd_precision.py)
constexpr float kReluTol = 1e-5f;

using digat::warp_max;
using digat::warp_sum;

// Calls f(std::integral_constant<int, kFixedL>{}) with kFixedL = L where an
// instance is compiled for it (32, 16), else 0 (L taken at run time);
// returns what f returns.
template <typename F>
inline cudaError_t with_title_length(int L, F&& f) {
  if (L == 32) return f(std::integral_constant<int, 32>{});
  if (L == 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 0>{});
}

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

// rows [32][RS] of a unit's dk columns of a row-major [L, ld] array, zero
// past dk and past row L, by cp.async: the caller commits and waits
__device__ __forceinline__ void load_unit(float* dst, const float* src, size_t ld, int dk,
                                          int RS, int L) {
  const int W = (dk + 3) & ~3;
  for (int e = threadIdx.x; e < kL * W; e += kAttnThreads) {
    const int i = e / W, c = e - i * W;
    const bool in = c < dk && (L == kL || i < L);
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i * RS + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(in ? src + i * ld + c : src), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void load_unit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// the unit's first L rows back to global memory
__device__ __forceinline__ void store_unit(float* dst, const float* src, size_t ld, int dk,
                                           int RS, int L) {
  for (int e = threadIdx.x; e < L * dk; e += kAttnThreads) {
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
// (seed, site) (philox.cuh); kept ones are scaled by drop_scale. T is float
// or bf16: a bf16 element is scaled in fp32 and rounded back once, to
// nearest even (the q|k|v product then reads it whole).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_apply_kernel(const T* in, T* out, long long n, int per_title, uint32_t thresh,
                     float drop_scale, uint32_t seed, uint32_t site) {
  const int groups = per_title / 4;
  const long long total = n * groups;
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long r = t / groups;
    const digat::Philox4 d =
        digat::dropout_draws(uint32_t(r), uint32_t(t - r * groups), seed, site);
    digat::store4(out + 4 * t, digat::dropout_value4(digat::load4(in + 4 * t), d, thresh,
                                                     drop_scale));
  }
}

// ---------------------------------------------------------------------------
// Attention forward of a unit (title n of L positions, head hd): h =
// relu(P v) with P = softmax(q k^T scale) over the L keys, written to the
// unit's columns of h (row stride ldh). kTrain (kernel A') also writes the rows' log-sum-exp and the head's
// part of dalpha = dp . h, and lists the unit where a pre-activation lies
// within kReluTol of 0; kernel A needs none of these, and may pass h = the
// q columns of qkv (ldh = 3D): a unit reads its q, k, v before it writes h.
// ---------------------------------------------------------------------------
template <bool kTrain, int kFixedL>
__global__ void __launch_bounds__(kAttnThreads, 8)
msa_attn_fwd_kernel(const float* qkv,                 // [N*L, 3D]
                    const float* __restrict__ dp,     // kTrain: [N, D]
                    float* h, int ldh,                // [N*L, ldh] out
                    float* __restrict__ lse,          // kTrain: [N, heads, L] out
                    float* __restrict__ dap,          // kTrain: [N, heads, L] out: dp . h per head
                    int* __restrict__ unsure,         // kTrain: [1 + N * heads]: count, then units
                    int title_len, int heads, int dk, float scale) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  const int L = kFixedL > 0 ? kFixedL : title_len;
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
  const float* rows = qkv + (size_t)n * L * 3 * D + hd * dk;
  load_unit(qs, rows, 3 * D, dk, RS, L);
  load_unit(ks, rows + D, 3 * D, dk, RS, L);
  load_unit(vs, rows + 2 * D, 3 * D, dk, RS, L);
  if (kTrain) {
    for (int c = threadIdx.x; c < RS; c += kAttnThreads)
      dps[c] = c < dk ? dp[(size_t)n * D + hd * dk + c] : 0.f;
  }
  load_unit_wait();

  // scores of row i against this warp's keys (-inf past L); the softmax
  // from each warp's max and sum over its keys (a warp with no key left
  // sums 0)
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
      s[jj] = kFull || w * kKeys + jj < L ? s[jj] * scale : -INFINITY;
      mw = fmaxf(mw, s[jj]);
    }
    float lw = 0.f;
    if (kFull || mw != -INFINITY) {
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) lw += expf(s[jj] - mw);
    }
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
    if (kTrain && w == 0 && (kFull || i < L)) lse[((size_t)n * heads + hd) * L + i] = m + logf(l);
  }
  __syncthreads();
  // h = relu(P v) for this thread's column groups, over q's rows; for
  // kernel A', a pre-activation of a row < L within kReluTol of
  // sum_j p_ij |v_jc| of 0 marks the unit
  int near0 = 0;
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    const int gi = w + kAttnWarps * r;
    if (gi < G) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f), a = o;
#pragma unroll 8
      for (int j = 0; j < L; ++j) {
        const float pj = P[i * kPS + j];
        const float4 vj = reinterpret_cast<const float4*>(vs + j * RS)[gi];
        axpy4(pj, vj, o);
        if (kTrain) axpy4(pj, make_float4(fabsf(vj.x), fabsf(vj.y), fabsf(vj.z), fabsf(vj.w)), a);
      }
      if (kTrain) {
        const float ov[4] = {o.x, o.y, o.z, o.w}, av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          near0 |= (kFull || i < L) && 4 * gi + c < dk && fabsf(ov[c]) <= kReluTol * av[c];
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
    if (w == 0 && (kFull || i < L)) {
      float da = 0.f;
      for (int gi = 0; gi < G; ++gi)
        da = dot4(reinterpret_cast<const float4*>(qs + i * RS)[gi],
                  reinterpret_cast<const float4*>(dps)[gi], da);
      dap[((size_t)n * heads + hd) * L + i] = da;
    }
  } else {
    __syncthreads();
  }
  store_unit(h + (size_t)n * L * ldh + hd * dk, qs, ldh, dk, RS, L);
}

// The pool's softmax weight of position `lane` (row = n * L + lane) of a
// title: its logit summed from `parts` per-warp-column parts in order, the
// -1e9 fill where the mask is off (an all-pad title gives uniform weights
// 1 / L), and -inf, weight 0, for a slot past L (`present` false). Every
// lane of the warp calls it.
__device__ __forceinline__ float pool_alpha(const float* __restrict__ lgpart, int parts,
                                            size_t M, size_t row, bool present, bool keep) {
  float lg = 0.f;
  if (present)
    for (int q = 0; q < parts; ++q) lg += lgpart[q * M + row];
  const float logit = present ? (keep ? lg : kMaskFill) : -INFINITY;
  const float mx = warp_max(logit);
  const float e = expf(logit - mx);
  return e / warp_sum(e);
}


// ---------------------------------------------------------------------------
// The long unit: titles of 33 to 128 positions, or heads wider than 64 (dk up
// to 128), the shapes the unit above does not take. A block of
// long_threads(L) = 32 ceil(L / 32) threads per (title, head), thread i
// owning query row i (and key i in kernel A''s backward). No row of q, k or v
// is held whole: shared memory holds the unit's scores S [L][long_ls(L)] (an
// odd row stride, so that thread i reading row i hits its own bank) and
// chunks of kChunk columns of the unit's arrays, [L][kChunkS] each. The
// scores are summed chunk by chunk, the columns in order; every output is
// formed chunk by chunk from S. At L 128 the forward takes 98 KB of shared
// memory and the backward (S, dS and four chunks) 195 KB, within the 227 KB
// of a block, at any dk. A simple design, right first: its time at L 48-128
// is in PERF.md, and making it fast is later work.
// ---------------------------------------------------------------------------
constexpr int kLongL = 128;         // the longest title: 4 warps, a row each thread
constexpr int kLongMaxDk = 128;     // the widest head the long unit takes
constexpr int kLongWarps = kLongL / 32;
constexpr int kChunk = 32;          // columns of a chunk
constexpr int kChunkS = kChunk + 1;  // row stride of a chunk in shared memory

// Whether a unit of L positions and dk columns runs the unit above (the
// short unit: L <= 32, dk <= 64) or the long one.
__host__ __device__ inline bool short_unit(int L, int dk) { return L <= kL && dk <= kMaxDk; }
__host__ __device__ inline int long_ls(int L) { return L | 1; }
__host__ __device__ inline int long_threads(int L) { return (L + 31) / 32 * 32; }

// Floats of shared memory of msa_attn_fwd_long_kernel: S, two chunks and a
// chunk of dp.
__host__ __device__ inline int attn_fwd_long_floats(int L) {
  return L * long_ls(L) + 2 * L * kChunkS + kChunk;
}

// columns [0, w) of rows [0, L) of a row-major array (row stride ld) -> a
// chunk [L][kChunkS], zero in columns [w, kChunk); every thread of the block
// takes part (consecutive threads on consecutive columns), the caller syncs
__device__ __forceinline__ void load_chunk(float* dst, const float* src, size_t ld, int L, int w) {
  for (int e = threadIdx.x; e < L * kChunk; e += blockDim.x) {
    const int i = e / kChunk, c = e - i * kChunk;
    dst[i * kChunkS + c] = c < w ? src[(size_t)i * ld + c] : 0.f;
  }
}

// row i of a chunk into registers
__device__ __forceinline__ void chunk_row(float (&r)[kChunk], const float* chunk, int i) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) r[c] = chunk[i * kChunkS + c];
}

// a . row j of a chunk, columns in order, added to s
__device__ __forceinline__ float chunk_dot(const float (&a)[kChunk], const float* chunk, int j,
                                           float s) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) s = fmaf(a[c], chunk[j * kChunkS + c], s);
  return s;
}

// acc += x * row j of a chunk
__device__ __forceinline__ void chunk_axpy(float (&acc)[kChunk], float x, const float* chunk,
                                           int j) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) acc[c] = fmaf(x, chunk[j * kChunkS + c], acc[c]);
}

// ---------------------------------------------------------------------------
// Attention forward of a long unit, the same outputs as msa_attn_fwd_kernel:
// h = relu(P v) into the unit's columns of h (row stride ldh); kTrain also
// the rows' log-sum-exp, dp . h per row for this head, and the unit listed
// where a pre-activation lies within kReluTol of 0. Kernel A may pass h = the
// q columns of qkv: q is read whole (for S) before any h is written.
// ---------------------------------------------------------------------------
template <bool kTrain>
__global__ void __launch_bounds__(kLongL)
msa_attn_fwd_long_kernel(const float* qkv,                 // [N*L, 3D]
                         const float* __restrict__ dp,     // kTrain: [N, D]
                         float* h, int ldh,                // [N*L, ldh] out
                         float* __restrict__ lse,          // kTrain: [N, heads, L] out
                         float* __restrict__ dap,          // kTrain: [N, heads, L] out
                         int* __restrict__ unsure,         // kTrain: [1 + N * heads]
                         int L, int heads, int dk, float scale) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [L][LS]: scores, then P
  const int LS = long_ls(L), D = heads * dk;
  float* c1 = S + L * LS;        // [L][kChunkS]: a chunk of q, then of v
  float* c2 = c1 + L * kChunkS;  // [L][kChunkS]: a chunk of k
  float* dpc = c2 + L * kChunkS;  // [kChunk]: kTrain, a chunk of the unit's dp
  const int n = blockIdx.x / heads, hd = blockIdx.x - n * heads;
  const int i = threadIdx.x;
  const bool row = i < L;
  const float* rows = qkv + (size_t)n * L * 3 * D + hd * dk;
  // S = q k^T scale, summed over the chunks in column order
  for (int c0 = 0; c0 < dk; c0 += kChunk) {
    const int w = min(kChunk, dk - c0);
    load_chunk(c1, rows + c0, 3 * D, L, w);
    load_chunk(c2, rows + D + c0, 3 * D, L, w);
    __syncthreads();
    if (row) {
      float qr[kChunk];
      chunk_row(qr, c1, i);
      for (int j = 0; j < L; ++j) S[i * LS + j] = chunk_dot(qr, c2, j, c0 ? S[i * LS + j] : 0.f);
    }
    __syncthreads();
  }
  // the row's softmax, P over S
  if (row) {
    float m = -INFINITY;
    for (int j = 0; j < L; ++j) m = fmaxf(m, S[i * LS + j] * scale);
    float l = 0.f;
    for (int j = 0; j < L; ++j) l += expf(S[i * LS + j] * scale - m);
    const float inv = 1.f / l;
    for (int j = 0; j < L; ++j) S[i * LS + j] = expf(S[i * LS + j] * scale - m) * inv;
    if (kTrain) lse[((size_t)n * heads + hd) * L + i] = m + logf(l);
  }
  // h = relu(P v), chunk by chunk; kTrain: dp . h and the kReluTol test
  int near0 = 0;
  float da = 0.f;
  for (int c0 = 0; c0 < dk; c0 += kChunk) {
    const int w = min(kChunk, dk - c0);
    __syncthreads();  // the last chunk's reads, and P, done
    load_chunk(c1, rows + 2 * D + c0, 3 * D, L, w);
    if (kTrain) {
      for (int c = threadIdx.x; c < kChunk; c += blockDim.x)
        dpc[c] = c < w ? dp[(size_t)n * D + hd * dk + c0 + c] : 0.f;
    }
    __syncthreads();
    if (row) {
      float o[kChunk], a[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) o[c] = a[c] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float pj = S[i * LS + j];
        chunk_axpy(o, pj, c1, j);
        if (kTrain) {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) a[c] = fmaf(pj, fabsf(c1[j * kChunkS + c]), a[c]);
        }
      }
      float* hi = h + ((size_t)n * L + i) * ldh + hd * dk + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < w) {
          if (kTrain) near0 |= fabsf(o[c]) <= kReluTol * a[c];
          const float r = fmaxf(o[c], 0.f);
          if (kTrain) da = fmaf(r, dpc[c], da);
          hi[c] = r;
        }
      }
    }
  }
  if (kTrain) {
    if (__syncthreads_or(near0) && threadIdx.x == 0) unsure[1 + atomicAdd(unsure, 1)] = blockIdx.x;
    if (row) dap[((size_t)n * heads + hd) * L + i] = da;
  }
}

// The pool's softmax weights of a title of L <= kLongL positions, a warp per
// title: lane l takes positions l, l + 32, ... (al[r] for position l + 32 r),
// each logit summed from its `parts` parts in order, the -1e9 fill where the
// mask is off (an all-pad title gives uniform weights 1 / L), weight 0 past L.
__device__ __forceinline__ void pool_alpha_long(const float* __restrict__ lgpart, int parts,
                                                size_t M, const unsigned char* __restrict__ mask,
                                                size_t n, int L, int lane,
                                                float (&al)[kLongWarps]) {
  float logit[kLongWarps];
  float mx = -INFINITY;
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) {
    const int l = lane + 32 * r;
    logit[r] = -INFINITY;
    if (l < L) {
      const size_t row = n * L + l;
      float lg = 0.f;
      for (int q = 0; q < parts; ++q) lg += lgpart[q * M + row];
      logit[r] = mask[row] != 0 ? lg : kMaskFill;
    }
    mx = fmaxf(mx, logit[r]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) {
    al[r] = expf(logit[r] - mx);
    sum += al[r];
  }
  const float inv = 1.f / warp_sum(sum);
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) al[r] *= inv;
}

// the value that lane (l & 31) holds in al[l >> 5], for every lane of the warp
__device__ __forceinline__ float lane_value(const float (&al)[kLongWarps], int l) {
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kLongWarps; ++r) {
    const float x = __shfl_sync(0xffffffffu, al[r], l & 31);
    if ((l >> 5) == r) v = x;
  }
  return v;
}

}  // namespace
