// Eq. (8) score tiles in registers, for sm_90a: the score loop shared by
// kernel C's bf16 forward (gat_scores.cu, gat_scores_fwd_bf16) and kernel
// B's bf16-activation instance (gat_layer.cu, gat_layer_fused_bf16). It is
// the score half of the TPU kernels digat_tpu/ops/pallas/gat_scores.py
// (_scores_kernel) and digat_tpu/ops/pallas/gat_layer.py (_layer_kernel),
// which hold a batch tile's k1, k2 + k3 and scores in VMEM:
//
//     s[i, j] = sum over d of a[d] relu(k1[j, d] + c[i, d]),   c = fl(k2 + k3)
//
// formed as relu(t) = (t + |t|) / 2:
//
//     s[i, j] = (P[j] + Q[i] + sum over d of a[d] |k1[j, d] + c[i, d]|) / 2,
//     P[j] = sum over d of a[d] k1[j, d],   Q[i] = sum over d of a[d] c[i, d]
//
// so that each (i, j, d) costs two fp32 instructions, an FADD and an FFMA
// that reads |t| (the FFMA takes the absolute value of an operand for
// free), in place of three (add, max, multiply-add); P and Q cost G D
// multiply-adds each. The sums differ from the plain version's in their
// rounding only: each within a few fp32 ulps of sum |a t| (the float64
// replay in tests/test_torch_gat_bf16_tiles.py bounds it), which the bf16
// outputs of both kernels round away.
//
// What bounds it on an H100: issue. Two fp32 instructions an (i, j, d) at
// 132 SMs x 128 lanes x 1.98 GHz = 33.4 T a second, against 2 or 4 bytes a
// feature of each row of k1 and k2.
//
// A block's tile: R * TIb rows i and R * TJb columns j of one graph. Thread
// (ti, tj) keeps the R x R scores of rows i0 + ti + q TIb and columns j0 +
// tj + r TJb (q, r < R) in registers: a thread's rows and columns lie TIb
// and TJb apart, so that neighbouring threads read neighbouring staged
// rows. The features go in slices of kSlice, staged in shared memory as
// fp32 rows of kRow floats (nine float4s, an odd number: the float4 loads of
// eight neighbouring rows hit eight different bank groups), c's rows first,
// then k1's; a thread reads, per four features, one float4 of each of its R
// rows and R columns and one of a, for 4 R R (add, multiply-add): about 2.14
// issued instructions a score element at R 4.
//
// Staging. The rows are copied in 16-byte chunks (four fp32 or eight bf16
// features; or, where a chunk may not be read as one vector, element by
// element), at most kMaxPre chunks a thread, held in registers: the next
// slice's chunks are loaded before the current slice is summed and stored
// into the other of two shared-memory buffers after it, converted to fp32,
// c = k2 + k3 formed there once (k3 staged once a block, zero past D), with
// one barrier a slice. Features past D and rows past the graph are zero. A
// thread stages the same chunks of the same rows in every slice, and sums
// their a-weighted features as it stores them; the cpr threads of a row
// then add their parts (P or Q) by shuffles, in a fixed order.
//
// Every score sums its features in order from 0, one fmaf each, and P, Q
// and the halving in a fixed order: the same bits on every run.
// tests/test_torch_gat_bf16_tiles.py replays the tiles, the staging, the
// sums and the plan (ops/gat_scores.py tile_plan) on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace digat {
namespace gs {

constexpr int kSlice = 32;        // features of one staged slice
constexpr int kRow = kSlice + 4;  // floats of a staged row
constexpr int kMaxThreads = 320;  // a block
constexpr int kMaxPre = 4;        // 16-byte chunks a thread holds in flight

// Threads of a block of TIb x TJb tiles of R x R: one a tile, and enough to
// hold a slice's chunks (cpr a row) kMaxPre at a time; a multiple of 32
// (ops/gat_scores.py tile_threads).
__host__ __device__ inline int tile_threads(int R, int TIb, int TJb, int cpr) {
  const int tiles = TIb * TJb, chunks = R * (TIb + TJb) * cpr;
  const int need = tiles > (chunks + kMaxPre - 1) / kMaxPre ? tiles
                                                            : (chunks + kMaxPre - 1) / kMaxPre;
  return (need + 31) / 32 * 32;
}

// floats of the staged slices (two buffers) of a tile of BI rows, BJ columns,
// and their rows' sums P and Q (rounded up to float4s)
__host__ __device__ inline int stage_floats(int BI, int BJ) {
  return 2 * (BI + BJ) * kRow + ((BI + BJ + 3) & ~3);
}

// D rounded up to whole slices: the length of a block's staged a and k3
__host__ __device__ inline int slice_span(int D) { return (D + kSlice - 1) / kSlice * kSlice; }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// The 16 bytes of features d .. d + kE - 1 of a row (zero past D): one vector
// load (kVec: the chunk lies wholly inside or wholly past D) or kE loads.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_chunk(const T* row, int d, int D) {
  constexpr int kE = 16 / sizeof(T);
  if constexpr (kVec) {
    return d < D ? __ldg(reinterpret_cast<const uint4*>(row + d)) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int u = 0; u < kE; ++u) {
    if (d + u >= D) break;
    if constexpr (std::is_same<T, float>::value) {
      w[u] = __float_as_uint(__ldg(row + d + u));
    } else {
      const uint32_t h = __bfloat16_as_ushort(row[d + u]);
      w[u / 2] |= u % 2 ? h << 16 : h;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// dot += a . f over four features, in order
__device__ __forceinline__ float dot4(const float* as, float4 f, float dot) {
  const float4 a = *reinterpret_cast<const float4*>(as);
  dot = fmaf(a.x, f.x, dot);
  dot = fmaf(a.y, f.y, dot);
  dot = fmaf(a.z, f.z, dot);
  return fmaf(a.w, f.w, dot);
}

// A chunk as fp32 at `dst` (16-byte aligned), k3's features added where
// `k3s` is given (c = k2 + k3, rounded once); returns dot plus the chunk's
// features weighted by a (`as`, its features' a).
template <typename T>
__device__ __forceinline__ float store_chunk(float* dst, uint4 v, const float* k3s,
                                             const float* as, float dot) {
  if constexpr (std::is_same<T, float>::value) {
    float4 f = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                           __uint_as_float(v.w));
    if (k3s) {
      const float4 k = *reinterpret_cast<const float4*>(k3s);
      f = make_float4(f.x + k.x, f.y + k.y, f.z + k.z, f.w + k.w);
    }
    *reinterpret_cast<float4*>(dst) = f;
    return dot4(as, f, dot);
  } else {
    float4 lo = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
    float4 hi = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w));
    if (k3s) {
      const float4 a = *reinterpret_cast<const float4*>(k3s);
      const float4 b = *reinterpret_cast<const float4*>(k3s + 4);
      lo = make_float4(lo.x + a.x, lo.y + a.y, lo.z + a.z, lo.w + a.w);
      hi = make_float4(hi.x + b.x, hi.y + b.y, hi.z + b.z, hi.w + b.w);
    }
    *reinterpret_cast<float4*>(dst) = lo;
    *reinterpret_cast<float4*>(dst + 4) = hi;
    return dot4(as + 4, hi, dot4(as, lo, dot));
  }
}

// One block's view of its graph's rows: k2 (the tile's rows i0 ..) and k1
// (its columns j0 ..), rows ld elements apart, D features.
template <typename T>
struct Rows {
  const T* k1;
  const T* k2;
  int ld1, ld2, G, D;
};

// A slice's chunks in registers: chunk e of the slice (e = tid + u
// nthreads) is staged row e / cpr (c's BI rows, then k1's BJ), its
// (e % cpr)-th 16 bytes; dot[u] its a-weighted features so far.
template <typename T, bool kVec>
struct Stager {
  static constexpr int kE = 16 / sizeof(T), kCpr = kSlice / kE;
  uint4 pre[kMaxPre];
  float dot[kMaxPre];

  __device__ __forceinline__ void load(const Rows<T>& g, int i0, int j0, int BI, int BJ, int d0,
                                       int tid, int nthreads) {
#pragma unroll
    for (int u = 0; u < kMaxPre; ++u) {
      const int e = tid + u * nthreads, r = e / kCpr, d = d0 + (e % kCpr) * kE;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < BI) {
        if (i0 + r < g.G) v = load_chunk<T, kVec>(g.k2 + (size_t)(i0 + r) * g.ld2, d, g.D);
      } else if (r < BI + BJ) {
        if (j0 + r - BI < g.G) v = load_chunk<T, kVec>(g.k1 + (size_t)(j0 + r - BI) * g.ld1, d, g.D);
      }
      pre[u] = v;
    }
  }

  __device__ __forceinline__ void store(float* buf, const float* k3s, const float* as, int BI,
                                        int BJ, int d0, int tid, int nthreads) {
#pragma unroll
    for (int u = 0; u < kMaxPre; ++u) {
      const int e = tid + u * nthreads, r = e / kCpr, dd = (e % kCpr) * kE;
      if (r < BI + BJ)
        dot[u] = store_chunk<T>(buf + r * kRow + dd, pre[u], r < BI ? k3s + d0 + dd : nullptr,
                                as + d0 + dd, dot[u]);
    }
  }

  // Each row's sum (Q of c's rows, P of k1's) into sums[row]: the parts of
  // its cpr threads (neighbouring lanes) added by shuffles, in a fixed order.
  __device__ __forceinline__ void finish(float* sums, int BI, int BJ, int tid,
                                         int nthreads) const {
#pragma unroll
    for (int u = 0; u < kMaxPre; ++u) {
      const int e = tid + u * nthreads;
      float v = dot[u];
#pragma unroll
      for (int o = 1; o < kCpr; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (e % kCpr == 0 && e / kCpr < BI + BJ) sums[e / kCpr] = v;
    }
  }
};

// acc[q][r] += the slice's a |k1 + c| of row ti + q TIb and column tj + r
// TJb (staged row BI + tj + r TJb), nd features (a multiple of 4) from `as`.
template <int R>
__device__ __forceinline__ void sweep(float (&acc)[R][R], const float* buf, const float* as,
                                      int BI, int ti, int tj, int TIb, int TJb, int nd) {
  const float* cb = buf + ti * kRow;
  const float* kb = buf + (BI + tj) * kRow;
#pragma unroll 1
  for (int d = 0; d < nd; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(as + d);
    float4 c[R], k[R];
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] = *reinterpret_cast<const float4*>(cb + q * TIb * kRow + d);
#pragma unroll
    for (int r = 0; r < R; ++r) k[r] = *reinterpret_cast<const float4*>(kb + r * TJb * kRow + d);
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = acc[q][r];
        s = fmaf(a.x, fabsf(k[r].x + c[q].x), s);
        s = fmaf(a.y, fabsf(k[r].y + c[q].y), s);
        s = fmaf(a.z, fabsf(k[r].z + c[q].z), s);
        s = fmaf(a.w, fabsf(k[r].w + c[q].w), s);
        acc[q][r] = s;
      }
  }
}

// The block's R x R scores a thread over every feature: rows i0 + ti + q
// TIb and columns j0 + tj + r TJb of graph `g` (zero where past G), from
// `as` (a, fp32, zero from D to slice_span(D)) and `k3s` (likewise; both
// staged before a barrier), through `stage` (stage_floats(R TIb, R TJb)).
// Every thread of the block calls it; `active` ones (ti < TIb) sum. Ends
// with a barrier: `stage` may be reused.
template <int R, typename T, bool kVec>
__device__ __forceinline__ void score_tile(float (&acc)[R][R], const Rows<T>& g, int i0, int j0,
                                           int TIb, int TJb, const float* as, const float* k3s,
                                           float* stage, bool active, int ti, int tj) {
  const int BI = R * TIb, BJ = R * TJb, tid = threadIdx.x, nthreads = blockDim.x;
  const int half = (BI + BJ) * kRow, Dp = (g.D + 3) & ~3, slices = (Dp + kSlice - 1) / kSlice;
  float* sums = stage + 2 * half;  // Q of c's rows, then P of k1's
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.f;
  Stager<T, kVec> st;
#pragma unroll
  for (int u = 0; u < kMaxPre; ++u) st.dot[u] = 0.f;
  st.load(g, i0, j0, BI, BJ, 0, tid, nthreads);
  st.store(stage, k3s, as, BI, BJ, 0, tid, nthreads);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int d0 = s * kSlice;
    const bool more = s + 1 < slices;
    if (more) st.load(g, i0, j0, BI, BJ, d0 + kSlice, tid, nthreads);
    if (active) sweep<R>(acc, stage + (s & 1) * half, as + d0, BI, ti, tj, TIb, TJb,
                         min(kSlice, Dp - d0));
    if (more) st.store(stage + ((s + 1) & 1) * half, k3s, as, BI, BJ, d0 + kSlice, tid, nthreads);
    __syncthreads();
  }
  st.finish(sums, BI, BJ, tid, nthreads);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[q][r] = 0.5f * ((sums[BI + tj + r * TJb] + sums[ti + q * TIb]) + acc[q][r]);
  }
  __syncthreads();
}

}  // namespace gs
}  // namespace digat
