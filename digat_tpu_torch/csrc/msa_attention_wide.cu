// The masked attention pair's wide instance (msa_attention_kernels.cuh):
// heads of dk 65 to 128, fp32 and bf16 (q, k, v, do and the outputs of
// element type T, the rows held and the sums run in fp32, each output
// rounded once to T), in a file of its own so that nvcc compiles it beside
// the register-row instances, in parallel.

#include "msa_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// The wide instance: heads of dk 65 to 128. A warp per unit, a block each. A
// row of 128 floats does not fit the registers beside an accumulator as wide
// (the register-row kernels above would spill), so every row is read from
// shared memory in float4 chunks, and the accumulators cover part of the
// columns at a time. k and v sit in shared memory as in the backward above
// (rows KS = 132 floats apart), and the warp's 32 query rows are staged there
// in turn, lane i reading its own row (33 float4s apart: 8 lanes, 8 bank
// quads).
//  * Forward: per 32-row chunk, the online softmax over kTile-key tiles as
//    above, once for each half of the columns (64 accumulators; the scores
//    formed twice).
//  * Backward: part 1 as the long backward's, the warp's rows of q and do
//    staged, the row statistics online, then dq a quarter of the columns at
//    a time (the scores and dp formed again for each quarter); part 2 with q
//    and do in the place of k and v and the warp's key rows staged, dk and
//    dv a quarter at a time.
// Shared memory caps L: 203 forward, 185 backward (wide_fwd_floats,
// wide_bwd_floats; ops/msa_attention.py's `max_length`).
// ---------------------------------------------------------------------------
// columns [c0, c0 + n) of an output row: r[c] where c0 + c < dk, zero in
// [dk, hs); with `tail` also the zeros of [kWide, hs) (scalar stores,
// rounded to T)
template <int n, typename T>
__device__ __forceinline__ void store_cols(T* dst, const float (&r)[n], int c0, int dk, int hs,
                                           bool tail) {
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if (c0 + c < hs) dst[c0 + c] = from_float<T>(c0 + c < dk ? r[c] : 0.f);
  }
  if (tail)
    for (int c = kWide; c < hs; ++c) dst[c] = from_float<T>(0.f);
}

template <bool VEC, typename T>
__global__ void __launch_bounds__(32)
msa_attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* __restrict__ mask,
                              T* __restrict__ out, int units, int H, int L, int dk, int rs,
                              int hs, float scale) {
  constexpr int KS = kv_stride(kWide);
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x;
  float* Ks = reinterpret_cast<float*>(smem4);  // [L][KS]
  float* Vs = Ks + L * KS;                      // [L][KS]
  float* Qw = Vs + L * KS;                      // [32][KS]: the chunk's q rows
  unsigned char* keep = reinterpret_cast<unsigned char*>(Qw + 32 * KS);  // [L]
  const int unit = blockIdx.x;
  if (unit >= units) return;
  const int n = unit / H, h = unit - n * H;
  const size_t base = size_t(n) * L * rs + size_t(h) * hs;
  load_rows<kWide, KS, VEC>(Ks, k + base, L, dk, rs, lane, 32);
  load_rows<kWide, KS, VEC>(Vs, v + base, L, dk, rs, lane, 32);
  load_keep(keep, mask, n, L, lane, 32);
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int rows = min(32, L - i0);
    __syncwarp();  // the last chunk's q rows read
    load_rows<kWide, KS, VEC>(Qw, q + base + size_t(i0) * rs, rows, dk, rs, lane, 32);
    if constexpr (VEC) cp_async_wait_all();
    __syncwarp();
    const int i = i0 + lane;
    const float* qi = Qw + min(lane, rows - 1) * KS;  // lanes past L redo row L - 1, unused
    for (int c0 = 0; c0 < kWide; c0 += kWideHalf) {
      float acc[kWideHalf];
      zero<kWideHalf>(acc);
      float m = -INFINITY, sum = 0.f;
      for (int j0 = 0; j0 < L; j0 += kTile) {
        float s[kTile];
        float tile_max = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int j = j0 + jj;
          float x = -INFINITY;  // past L: counts exactly 0
          if (j < L) x = keep[j] ? dot_ss<kWide>(qi, Ks + j * KS) * scale : kMaskFill;
          s[jj] = x;
          tile_max = fmaxf(tile_max, x);
        }
        const float m_new = fmaxf(m, tile_max);  // finite: tile 0 holds key 0
        const float corr = expf(m - m_new);
        sum *= corr;
#pragma unroll
        for (int c = 0; c < kWideHalf; ++c) acc[c] *= corr;
        m = m_new;
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int j = j0 + jj;
          if (j < L) {
            const float e = expf(s[jj] - m_new);
            sum += e;
            axpy<kWideHalf>(acc, e, Vs + j * KS + c0);
          }
        }
      }
      if (i < L) {
        const float inv = 1.f / sum;
#pragma unroll
        for (int c = 0; c < kWideHalf; ++c) acc[c] *= inv;
        store_cols<kWideHalf>(out + base + size_t(i) * rs, acc, c0, dk, hs,
                              c0 + kWideHalf == kWide);
      }
    }
  }
}

template <bool VEC, typename T>
__global__ void __launch_bounds__(32)
msa_attention_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* __restrict__ mask,
                              const T* __restrict__ dout, T* __restrict__ dq,
                              T* __restrict__ dk_out, T* __restrict__ dv_out, int units,
                              int H, int L, int dk, int rs, int hs, float scale) {
  constexpr int KS = kv_stride(kWide);
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x;
  float* X = reinterpret_cast<float*>(smem4);  // [L][KS]: k, then q
  float* Y = X + L * KS;                       // [L][KS]: v, then do
  float* Aw = Y + L * KS;                      // [32][KS]: the chunk's q rows, then k rows
  float* Bw = Aw + 32 * KS;                    // [32][KS]: the chunk's do rows, then v rows
  float* M = Bw + 32 * KS;                     // [L]: each row's max,
  float* R = M + L;                            // 1 / sum of exp(s - max)
  float* Ts = R + L;                           // and t
  unsigned char* keep = reinterpret_cast<unsigned char*>(Ts + L);  // [L]
  const int unit = blockIdx.x;
  if (unit >= units) return;
  const int n = unit / H, h = unit - n * H;
  const size_t base = size_t(n) * L * rs + size_t(h) * hs;
  load_rows<kWide, KS, VEC>(X, k + base, L, dk, rs, lane, 32);
  load_rows<kWide, KS, VEC>(Y, v + base, L, dk, rs, lane, 32);
  load_keep(keep, mask, n, L, lane, 32);
  // ---- part 1, lane per query row: row statistics, then dq ----
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int rows = min(32, L - i0);
    __syncwarp();
    load_rows<kWide, KS, VEC>(Aw, q + base + size_t(i0) * rs, rows, dk, rs, lane, 32);
    load_rows<kWide, KS, VEC>(Bw, dout + base + size_t(i0) * rs, rows, dk, rs, lane, 32);
    if constexpr (VEC) cp_async_wait_all();
    __syncwarp();
    const int i = i0 + lane;
    const float* qi = Aw + min(lane, rows - 1) * KS;  // lanes past L redo row L - 1, unused
    const float* di = Bw + min(lane, rows - 1) * KS;
    float m = -INFINITY, z = 0.f, tu = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      float s[kTile], dp[kTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        const int j = j0 + jj;
        float x = -INFINITY, y = 0.f;  // past L: counts exactly 0
        if (j < L) {
          x = keep[j] ? dot_ss<kWide>(qi, X + j * KS) * scale : kMaskFill;
          y = dot_ss<kWide>(di, Y + j * KS);
        }
        s[jj] = x;
        dp[jj] = y;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m, tile_max);  // finite: tile 0 holds key 0
      const float corr = expf(m - m_new);
      z *= corr;
      tu *= corr;
      m = m_new;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        if (j0 + jj < L) {
          const float e = expf(s[jj] - m_new);
          z += e;
          tu = fmaf(e, dp[jj], tu);
        }
      }
    }
    const float inv = 1.f / z;
    const float t = tu * inv;
    for (int c0 = 0; c0 < kWide; c0 += kWideQuarter) {
      float g[kWideQuarter];
      zero<kWideQuarter>(g);
      for (int j = 0; j < L; ++j) {
        if (keep[j]) {  // a masked key has ds 0
          const float p = expf(dot_ss<kWide>(qi, X + j * KS) * scale - m) * inv;
          axpy<kWideQuarter>(g, p * (dot_ss<kWide>(di, Y + j * KS) - t) * scale,
                             X + j * KS + c0);
        }
      }
      if (i < L)
        store_cols<kWideQuarter>(dq + base + size_t(i) * rs, g, c0, dk, hs,
                                 c0 + kWideQuarter == kWide);
    }
    if (i < L) {
      M[i] = m;
      R[i] = inv;
      Ts[i] = t;
    }
  }
  // ---- part 2, lane per key: q and do in the place of k and v ----
  __syncwarp();
  load_rows<kWide, KS, VEC>(X, q + base, L, dk, rs, lane, 32);
  load_rows<kWide, KS, VEC>(Y, dout + base, L, dk, rs, lane, 32);
  for (int j0 = 0; j0 < L; j0 += 32) {
    const int rows = min(32, L - j0);
    __syncwarp();
    load_rows<kWide, KS, VEC>(Aw, k + base + size_t(j0) * rs, rows, dk, rs, lane, 32);
    load_rows<kWide, KS, VEC>(Bw, v + base + size_t(j0) * rs, rows, dk, rs, lane, 32);
    if constexpr (VEC) cp_async_wait_all();
    __syncwarp();
    const int j = j0 + lane;
    const float* kj = Aw + min(lane, rows - 1) * KS;  // lanes past L redo key L - 1, unused
    const float* vj = Bw + min(lane, rows - 1) * KS;
    const bool kept = keep[min(j, L - 1)];
    for (int c0 = 0; c0 < kWide; c0 += kWideQuarter) {
      float gk[kWideQuarter], gv[kWideQuarter];
      zero<kWideQuarter>(gk);
      zero<kWideQuarter>(gv);
      for (int r = 0; r < L; ++r) {
        const float x = kept ? dot_ss<kWide>(kj, X + r * KS) * scale : kMaskFill;
        const float p = expf(x - M[r]) * R[r];
        const float ds = kept ? p * (dot_ss<kWide>(vj, Y + r * KS) - Ts[r]) * scale : 0.f;
        axpy<kWideQuarter>(gk, ds, X + r * KS + c0);
        axpy<kWideQuarter>(gv, p, Y + r * KS + c0);
      }
      if (j < L) {
        const bool tail = c0 + kWideQuarter == kWide;
        store_cols<kWideQuarter>(dk_out + base + size_t(j) * rs, gk, c0, dk, hs, tail);
        store_cols<kWideQuarter>(dv_out + base + size_t(j) * rs, gv, c0, dk, hs, tail);
      }
    }
  }
}

}  // namespace

namespace digat {

template <typename T>
FwdKernel<T> attention_fwd_wide(bool vec) {
  return vec ? msa_attention_fwd_wide_kernel<true, T> : msa_attention_fwd_wide_kernel<false, T>;
}

template <typename T>
BwdKernel<T> attention_bwd_wide(bool vec) {
  return vec ? msa_attention_bwd_wide_kernel<true, T> : msa_attention_bwd_wide_kernel<false, T>;
}

template FwdKernel<float> attention_fwd_wide<float>(bool);
template FwdKernel<__nv_bfloat16> attention_fwd_wide<__nv_bfloat16>(bool);
template BwdKernel<float> attention_bwd_wide<float>(bool);
template BwdKernel<__nv_bfloat16> attention_bwd_wide<__nv_bfloat16>(bool);

}  // namespace digat
