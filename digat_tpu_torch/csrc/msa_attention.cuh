// Pieces of the masked attention pair (msa_attention.cu) that its wide
// instance (msa_attention_wide.cu) shares: constants, the shared-memory
// layout, and the row loads and products. Each file that includes this
// header gets its own copy (an unnamed namespace); the two kernel files
// are compiled apart, in parallel, and the wide kernels reach the entry
// points of msa_attention.cu through `digat::attention_fwd_wide` and
// `digat::attention_bwd_wide`.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;  // warps of a block of independent warps
constexpr int kMaxGroup = 8;  // warps sharing one unit beyond kShortL
constexpr int kTile = 16;     // keys per step of an online softmax
constexpr int kShortL = 32;   // the longest L at which a warp owns a unit
constexpr float kMaskFill = -1e9f;
constexpr int kWidths[] = {8, 16, 20, 24, 32, 48, 64};  // the register-row instances
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
// the wide instance, dk 65 to 128 (ops/msa_attention.py's WIDTHS end with it)
constexpr int kWide = 128;
constexpr int kWideHalf = kWide / 2;  // output columns a forward pass forms
constexpr int kWideQuarter = 32;      // output columns a backward pass forms
constexpr int kBlockReserve = 1024;  // shared memory the card keeps per block

__host__ __device__ constexpr int kv_stride(int W) { return W % 8 ? W : W + 4; }

// floats of shared memory: the rows, then L mask bytes rounded up to 16
// bytes (so that consecutive warps' regions stay 16-byte aligned)
__host__ __device__ inline size_t keep_floats(int L) { return 4 * size_t((L + 15) / 16); }
__host__ __device__ inline size_t fwd_warp_floats(int L, int W) {
  return 2 * size_t(L) * W + keep_floats(L);
}
__host__ __device__ inline size_t bwd_warp_floats(int L, int W) {
  return 4 * size_t(L) * kv_stride(W) + 64 * size_t(L) + keep_floats(L);
}
__host__ __device__ inline size_t bwd_long_floats(int L, int W) {
  return 4 * size_t(L) * kv_stride(W) + 3 * size_t(L) + keep_floats(L);
}

// the wide instance: k and v (the backward's second part: q and do) rows,
// then the warp's 32 staged rows of one array (forward) or two (backward),
// then the backward's three statistics a row
__host__ __device__ inline size_t wide_fwd_floats(int L) {
  return 2 * size_t(L) * kv_stride(kWide) + 32 * kv_stride(kWide) + keep_floats(L);
}
__host__ __device__ inline size_t wide_bwd_floats(int L) {
  return 2 * size_t(L) * kv_stride(kWide) + 64 * kv_stride(kWide) + 3 * size_t(L) +
         keep_floats(L);
}

__device__ __forceinline__ int sw(int j, int i) { return j * 32 + (i ^ (j & 31)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [L][dk] at src (row stride rs) -> shared rows KS floats apart, zero
// in [dk, W); thread t of `threads`
template <int W, int KS, bool VEC>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int L, int dk, int rs, int t, int threads) {
  if constexpr (VEC) {
    constexpr int W4 = W / 4;
    for (int e = t; e < L * W4; e += threads) {
      const int l = e / W4, c = (e - l * W4) * 4;
      const int bytes = 4 * max(0, min(4, dk - c));
      cp_async16(dst + l * KS + c, src + size_t(l) * rs + (bytes ? c : 0), bytes);
    }
  } else {
    for (int e = t; e < L * W; e += threads) {
      const int l = e / W, c = e - l * W;
      dst[l * KS + c] = c < dk ? src[size_t(l) * rs + c] : 0.f;
    }
  }
}

__device__ __forceinline__ void load_keep(unsigned char* __restrict__ keep,
                                          const unsigned char* __restrict__ mask, size_t n, int L,
                                          int t, int threads) {
  for (int j = t; j < L; j += threads) keep[j] = mask == nullptr || mask[n * L + j];
}

template <int W>
__device__ __forceinline__ void row_from_smem(float (&r)[W], const float* __restrict__ s) {
#pragma unroll
  for (int c4 = 0; c4 < W / 4; ++c4) {
    const float4 x = reinterpret_cast<const float4*>(s)[c4];
    r[4 * c4] = x.x;
    r[4 * c4 + 1] = x.y;
    r[4 * c4 + 2] = x.z;
    r[4 * c4 + 3] = x.w;
  }
}

// the first dk floats of a row at src (global memory) -> r, zero in [dk, W)
template <int W, bool VEC>
__device__ __forceinline__ void row_from_global(float (&r)[W], const float* src, int dk) {
  if constexpr (VEC) {
#pragma unroll
    for (int c4 = 0; c4 < W / 4; ++c4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * c4 < dk) x = *reinterpret_cast<const float4*>(src + 4 * c4);
      r[4 * c4] = x.x;
      r[4 * c4 + 1] = 4 * c4 + 1 < dk ? x.y : 0.f;
      r[4 * c4 + 2] = 4 * c4 + 2 < dk ? x.z : 0.f;
      r[4 * c4 + 3] = 4 * c4 + 3 < dk ? x.w : 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) r[c] = c < dk ? src[c] : 0.f;
  }
}

// r[c] for c < dk and 0 for c in [dk, hs) -> the row at dst
template <int W, bool VEC>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[W], int dk, int hs) {
  if constexpr (VEC) {
#pragma unroll
    for (int c4 = 0; c4 < W / 4; ++c4) {
      if (4 * c4 < hs) {
        float4 x;
        x.x = 4 * c4 < dk ? r[4 * c4] : 0.f;
        x.y = 4 * c4 + 1 < dk ? r[4 * c4 + 1] : 0.f;
        x.z = 4 * c4 + 2 < dk ? r[4 * c4 + 2] : 0.f;
        x.w = 4 * c4 + 3 < dk ? r[4 * c4 + 3] : 0.f;
        *reinterpret_cast<float4*>(dst + 4 * c4) = x;
      }
    }
    for (int c = W; c < hs; c += 4) *reinterpret_cast<float4*>(dst + c) = make_float4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < hs) dst[c] = c < dk ? r[c] : 0.f;
    }
    for (int c = W; c < hs; ++c) dst[c] = 0.f;
  }
}

// a . b[0:W]: a in registers, b in shared memory read as float4 (a
// broadcast when every lane reads the same row); two chains
template <int W>
__device__ __forceinline__ float dot_rs(const float (&a)[W], const float* __restrict__ b) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < W / 4; ++c4) {
    const float4 y = reinterpret_cast<const float4*>(b)[c4];
    s0 = fmaf(a[4 * c4], y.x, s0);
    s1 = fmaf(a[4 * c4 + 1], y.y, s1);
    s0 = fmaf(a[4 * c4 + 2], y.z, s0);
    s1 = fmaf(a[4 * c4 + 3], y.w, s1);
  }
  return s0 + s1;
}

// the same with a in shared memory too: the same products in the same order
template <int W>
__device__ __forceinline__ float dot_ss(const float* __restrict__ a, const float* __restrict__ b) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < W / 4; ++c4) {
    const float4 x = reinterpret_cast<const float4*>(a)[c4];
    const float4 y = reinterpret_cast<const float4*>(b)[c4];
    s0 = fmaf(x.x, y.x, s0);
    s1 = fmaf(x.y, y.y, s1);
    s0 = fmaf(x.z, y.z, s0);
    s1 = fmaf(x.w, y.w, s1);
  }
  return s0 + s1;
}

// acc += x * b[0:W], b in shared memory read as float4
template <int W>
__device__ __forceinline__ void axpy(float (&acc)[W], float x, const float* __restrict__ b) {
#pragma unroll
  for (int c4 = 0; c4 < W / 4; ++c4) {
    const float4 y = reinterpret_cast<const float4*>(b)[c4];
    acc[4 * c4] = fmaf(x, y.x, acc[4 * c4]);
    acc[4 * c4 + 1] = fmaf(x, y.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(x, y.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(x, y.w, acc[4 * c4 + 3]);
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&r)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) r[c] = 0.f;
}

using FwdKernel = void (*)(const float*, const float*, const float*, const unsigned char*, float*,
                           int, int, int, int, int, int, float);
using BwdKernel = void (*)(const float*, const float*, const float*, const unsigned char*,
                           const float*, float*, float*, float*, int, int, int, int, int, int,
                           float);

}  // namespace

namespace digat {

// the wide instance (msa_attention_wide.cu), float4 loads or scalar ones
FwdKernel attention_fwd_wide(bool vec);
BwdKernel attention_bwd_wide(bool vec);

}  // namespace digat
