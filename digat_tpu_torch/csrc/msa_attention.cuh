// Pieces of the masked attention pair that its fp32 register-row kernels
// (msa_attention_kernels.cuh, instantiated by msa_attention.cu), its bf16
// register-row kernels (msa_attention_bf16.cuh: the constants) and its wide
// instance (msa_attention_wide.cu) share: constants, the shared-memory
// layout, and the row loads, stores and products. Each file that includes this header
// gets its own copy (an unnamed namespace); the kernel files are compiled
// apart, in parallel, and the entry points reach the wide instance through
// `digat::attention_fwd_wide<T>` and `digat::attention_bwd_wide<T>`, and
// the backward past 32 positions through `digat::attention_bwd_long<T>`.
//
// Element types. q, k, v, do and the outputs are T, fp32 or bf16. The fp32
// register-row kernels hold rows in fp32 (in shared memory and in
// registers); the wide instance and the bf16 register-row kernels keep bf16
// rows as bf16 for their tensor-core products; every sum runs in fp32 and
// an output is rounded once to T (to nearest even for bf16), as the TPU
// kernels load bf16 q, k and v into fp32, compute in fp32 and round their
// outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

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

__device__ __forceinline__ int sw(int j, int i) { return j * 32 + (i ^ (j & 31)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// four consecutive elements as a float4 (16-byte aligned fp32, 8-byte
// aligned bf16), and a float4 stored as four elements of T
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) { return digat::load4(p); }
__device__ __forceinline__ void st4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4 v) { digat::store4(p, v); }

// rows [L][dk] at src (row stride rs) -> shared rows KS floats apart, zero
// in [dk, W); thread t of `threads`. fp32 rows move by cp.async (float4
// rows) or as floats; bf16 rows through registers, four elements at a time
// (VEC: 8-byte aligned rows) or one, converted to fp32.
template <int W, int KS, bool VEC, typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int L, int dk, int rs, int t, int threads) {
  if constexpr (VEC && std::is_same<T, float>::value) {
    constexpr int W4 = W / 4;
    for (int e = t; e < L * W4; e += threads) {
      const int l = e / W4, c = (e - l * W4) * 4;
      const int bytes = 4 * max(0, min(4, dk - c));
      cp_async16(dst + l * KS + c, src + size_t(l) * rs + (bytes ? c : 0), bytes);
    }
  } else if constexpr (VEC) {
    constexpr int W4 = W / 4;
    for (int e = t; e < L * W4; e += threads) {
      const int l = e / W4, c = (e - l * W4) * 4;
      const T* row = src + size_t(l) * rs;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c + 4 <= dk) {
        x = ld4(row + c);
      } else if (c < dk) {
        x.x = to_float(row[c]);
        x.y = c + 1 < dk ? to_float(row[c + 1]) : 0.f;
        x.z = c + 2 < dk ? to_float(row[c + 2]) : 0.f;
      }
      *reinterpret_cast<float4*>(dst + l * KS + c) = x;
    }
  } else {
    for (int e = t; e < L * W; e += threads) {
      const int l = e / W, c = e - l * W;
      dst[l * KS + c] = c < dk ? to_float(src[size_t(l) * rs + c]) : 0.f;
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

// the first dk elements of a row at src (global memory) -> r, zero in [dk, W)
template <int W, bool VEC, typename T>
__device__ __forceinline__ void row_from_global(float (&r)[W], const T* src, int dk) {
  if constexpr (VEC) {
#pragma unroll
    for (int c4 = 0; c4 < W / 4; ++c4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * c4 < dk) x = ld4(src + 4 * c4);
      r[4 * c4] = x.x;
      r[4 * c4 + 1] = 4 * c4 + 1 < dk ? x.y : 0.f;
      r[4 * c4 + 2] = 4 * c4 + 2 < dk ? x.z : 0.f;
      r[4 * c4 + 3] = 4 * c4 + 3 < dk ? x.w : 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) r[c] = c < dk ? to_float(src[c]) : 0.f;
  }
}

// r[c] for c < dk and 0 for c in [dk, hs) -> the row at dst, rounded to T
template <int W, bool VEC, typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&r)[W], int dk, int hs) {
  if constexpr (VEC) {
#pragma unroll
    for (int c4 = 0; c4 < W / 4; ++c4) {
      if (4 * c4 < hs) {
        float4 x;
        x.x = 4 * c4 < dk ? r[4 * c4] : 0.f;
        x.y = 4 * c4 + 1 < dk ? r[4 * c4 + 1] : 0.f;
        x.z = 4 * c4 + 2 < dk ? r[4 * c4 + 2] : 0.f;
        x.w = 4 * c4 + 3 < dk ? r[4 * c4 + 3] : 0.f;
        st4(dst + 4 * c4, x);
      }
    }
    for (int c = W; c < hs; c += 4) st4(dst + c, make_float4(0.f, 0.f, 0.f, 0.f));
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < hs) dst[c] = from_float<T>(c < dk ? r[c] : 0.f);
    }
    for (int c = W; c < hs; ++c) dst[c] = from_float<T>(0.f);
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

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, const unsigned char*, T*, int, int, int,
                           int, int, int, float);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const unsigned char*, const T*, T*, T*,
                           T*, int, int, int, int, int, int, float);

}  // namespace

namespace digat {

// the wide instance (msa_attention_wide.cu): its kernels' shared-memory
// limit (once per device), and its launches with float4 loads (vec) or
// scalar ones; cudaErrorInvalidValue where a block's shared memory passes
// max_smem
template <typename T>
cudaError_t attention_wide_init(int max_smem);
template <typename T>
cudaError_t attention_fwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask,
                               T* out, int N, int H, int L, int dk, int rs, int hs, float scale,
                               bool vec, int max_smem, cudaStream_t stream);
template <typename T>
cudaError_t attention_bwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask,
                               const T* dout, T* dq, T* dk_out, T* dv_out, int N, int H, int L,
                               int dk, int rs, int hs, float scale, bool vec, int max_smem,
                               cudaStream_t stream);

// the fp32 register-row backward past kShortL positions
// (msa_attention_kernels.cuh, instantiated by msa_attention_long.cu): its
// kernels' shared-memory limit (once per device), and its launch;
// cudaErrorInvalidValue where a unit's shared memory passes max_smem
template <typename T>
cudaError_t attention_long_init(int max_smem);
template <typename T>
cudaError_t attention_bwd_long(const T* q, const T* k, const T* v, const unsigned char* mask,
                               const T* dout, T* dq, T* dk_out, T* dv_out, int N, int H, int L,
                               int dk, int rs, int hs, float scale, bool vec, int max_smem,
                               cudaStream_t stream);

}  // namespace digat
