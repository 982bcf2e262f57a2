// Masked multi-head self-attention, forward and backward, for sm_90a: the
// fp32 register-row kernels, templated on the element type T of q, k, v, do
// and the outputs, and instantiated for fp32 only (by msa_attention.cu; the
// backward past 32 positions by msa_attention_long.cu, which defines
// DIGAT_ATTENTION_LONG: two files that nvcc compiles in parallel), and the
// entry points' logic, which those files wrap in their C functions. The bf16
// instance (compute_dtype bfloat16) has kernels of its own, on the tensor
// cores: msa_attention_bf16.cuh.
//
// Replaces two TPU kernels that compute the same function:
//   digat_tpu/ops/pallas/msa_attention_grouped.py (msa_attention_grouped:
//     _fwd_kernel, _bwd_kernel; heads padded to dkp = 128 / g lanes, g heads
//     per 128-lane group), and
//   digat_tpu/ops/pallas/msa_attention.py (msa_attention: _fwd_kernel,
//     _bwd_kernel; heads packed dk apart).
// For each sequence n and head h, with a the softmax over keys j:
//
//     s[i, j]  = where(keep[j], (q[i] . k[j]) * scale, -1e9)
//     a[i, :]  = softmax(s[i, :]),   out[i] = sum_j a[i, j] v[j]
//     dp[i, j] = do[i] . v[j],       t[i] = sum_j a[i, j] dp[i, j]
//     ds[i, j] = keep[j] ? a[i, j] (dp[i, j] - t[i]) * scale : 0
//     dq[i] = sum_j ds[i, j] k[j],  dk[j] = sum_i ds[i, j] q[i],
//     dv[j] = sum_i a[i, j] do[i]
//
// scale is 1 / sqrt(dk) with the true head width dk. The mask is a select,
// as the reference's masked_fill and the JAX package's XLA path take it, so
// a masked key passes no gradient (the TPU kernels add -1e9 instead; the two
// differ only on a sequence whose keys are all masked).
//
// Layout: element (n, l, h, c) of every [N, L, .] operand sits at
// n * L * rs + l * rs + h * hs + c. The packed layout (F) has rs = H * dk and
// hs = dk; the head-padded layout (E) has rs = H * dkp and hs = dkp, and its
// pad lanes c in [dk, dkp) of out, dq, dk and dv are written as zeros.
//
// What bounds it on an H100: at the NRMS shapes (L 32-50, dk 20) memory.
// The forward does 4 L dk FLOP per (i, j) against 16 L dk bytes per head,
// 8 FLOP per byte at L 32: below the 20 FLOP per byte where fp32 CUDA-core
// arithmetic (67 TFLOP/s) would take over from HBM (3.35 TB/s). Inside the
// SM the shared-memory pipe (about one warp-wide load a clock, against four
// warp-wide FMAs) is the limit once each FMA needs its own shared load; so
// every shared load below feeds 4 FMAs in each of 32 lanes.
//
// Design. One warp owns one (sequence, head), a "unit", up to L 32; beyond,
// the warps of a block share one. The head width
// is a template parameter W, dk padded up to one of kWidths (dk <= 64), so
// that a row lives in registers as W floats; lanes c in [dk, W) are zero.
// Heads of dk 65 to 128 run the wide instance (msa_attention_wide.cu, its
// own file so that nvcc compiles it in parallel with this one).
// In the backward, rows sit in shared memory kv_stride(W) floats apart (W,
// or W + 4 where W is a multiple of 8), so that 32 lanes reading 32 rows as
// float4 hit every bank once; all lanes reading one row is a broadcast.
//
//  * Forward: k and v of the unit go to shared memory (by cp.async), W
//    floats a row, and each lane owns one query row i (32 rows a pass;
//    beyond L 32 the min(8, ceil(L / 32)) warps of a block share one unit
//    and take its chunks of 32 rows in turn): its q row, loaded from global
//    memory, and its output accumulator sit in registers, and every k_j
//    and v_j is read by all lanes at one address,
//    a broadcast 16-byte load feeding 4 FMAs for every lane. Softmax is
//    online over tiles of kTile = 16 keys, inside the lane: the tile's
//    scores in registers, a running max and sum, the accumulator rescaled
//    by exp(m_old - m_new). Keys past L score -inf (they count
//    exactly 0), masked keys -1e9, so an all-masked sequence is uniform over
//    its L keys. The first tile always holds key 0, so m is finite after it
//    and exp(m_old - m_new) is never exp(-inf + inf). Up to L 32 a block
//    holds 1-4 independent warps on consecutive units (consecutive heads of
//    a sequence), as many as keep the most warps resident per SM by shared
//    memory and the kernel's registers (read at init).
//  * Backward, L <= 32 (the titles): a warp per unit, its q, do, k and v in
//    shared memory, two passes, and no score is computed twice.
//    Pass 1, lane per query row i, over the keys in order: s_ij to P and
//    the row max; then e_ij = exp(s_ij - m), the sum, dp_ij = do_i . v_j
//    to S and t_i = (sum_j e_ij dp_ij) / sum; then p_ij = e_ij / sum,
//    ds_ij = keep_j ? p_ij (dp_ij - t_i) scale : 0 back into P and S, and
//    dq_i = sum_j ds_ij k_j in registers, written once.
//    Pass 2, lane per key j: dk_j = sum_i ds_ij q_i and dv_j = sum_i p_ij
//    do_i in registers over the rows in order, reading P and S down column
//    j and q_i, do_i as broadcast loads, written once.
//    P and S are [L][32] with column i of key j at j * 32 + (i ^ (j & 31)):
//    pass 1 (lanes = i, one j) and pass 2 (lanes = j, one i) both touch 32
//    distinct banks.
//  * Backward, L > 32 (the user tower, F's long sequences): storing P and S
//    for 32 rows by L keys per warp would take 38 KB at L 150 on top of
//    the unit's 48 KB of rows and leave 2 warps an SM, so this kernel
//    recomputes the scores instead and shares one unit's rows among the
//    min(8, ceil(L / 32)) warps of its block.
//    Part 1, lane per query row, the warps taking 32-row chunks in turn:
//    s_ij and dp_ij over 16-key tiles with the max, the sum and
//    sum_j e_ij dp_ij online (rescaled tile by tile), t_i = that / sum;
//    the row's max, sum and t go to shared memory; then over the keys in
//    order, s_ij and dp_ij again, p_ij = exp(s_ij - m_i) / sum_i,
//    ds_ij and dq_i = sum_j ds_ij k_j, written once.
//    Part 2 (after a block barrier), lane per key j, the warps taking 32-key
//    tiles in turn: the transposed pass. Over the rows i in order, with q_i,
//    do_i and row i's max, sum and t read as broadcasts and k_j, v_j held by
//    the lane: s_ij, p_ij, dp_ij and ds_ij again, dk_j += ds_ij q_i and
//    dv_j += p_ij do_i in registers, written once.
//    That is 9 W FMAs per (i, j) against 5 W for the kernel above, for
//    50 KB of shared memory a block at L 150: 10 warps an SM, not 2.
// Every "/ sum" is a multiply by the reciprocal, taken once per row.
// Registers: without a minimum of blocks per SM in __launch_bounds__, ptxas
// traded spills for occupancy (a few bytes in some instantiations, which
// ones changing from build to build); with a minimum of 1 it spills nothing.
// scripts/attention_variants.py times the two and the other choices above.
// Each element of dq, dk and dv is summed by one lane in one fixed order,
// with no float atomics, so the same bits come out on every run.
//
//  * Loads: where rs, hs and every pointer are aligned to four elements,
//    rows move as groups of four (fp32: cp.async into shared memory,
//    zero-filled past dk; bf16: 8-byte loads through registers, converted)
//    and results are stored as groups of four; else a scalar instantiation
//    of the same kernel loads and stores elements (dk 6 or 7, a view with
//    an odd storage offset). ops/msa_attention.py's `launch_plan` states the
//    same rule.
//  * bf16 (compute_dtype bfloat16): the TPU kernels load bf16 q, k and v
//    into fp32, compute the scores, the softmax, P v and the whole backward
//    in fp32, and round out, dq, dk and dv to bf16 (msa_attention.py:69-72,
//    84-104). The bf16 instance computes the same function with kernels of
//    its own (msa_attention_bf16.cuh: bf16 rows, products on the tensor
//    cores); these templates would take T = __nv_bfloat16 (rows converted
//    to fp32 on their way in, each output rounded once to nearest even),
//    but nothing instantiates them so.
//
// Shared memory, with KS = kv_stride(W) and L mask bytes rounded up to 16
// after the floats: forward 2 L W a unit; backward at L <= 32 4 L KS + 64 L
// a unit, at L > 32 4 L KS + 3 L. A launch needs one unit's worth, which
// caps L (ops/msa_attention.py's `max_length`): at dk 20 the backward takes
// L up to 698 and the forward 1,443.

#pragma once

#include "msa_attention.cuh"


namespace {

// set by init_impl
int g_max_smem = 0;  // opt-in shared memory per block
int g_sm_smem = 0;   // shared memory per SM
int g_sm_regs = 0;   // registers per SM
int g_regs[2][2][kNumWidths] = {};  // [forward, short backward][float4 loads][width]

int width_index(int dk) {
  for (int i = 0; i < kNumWidths; ++i) {
    if (dk <= kWidths[i]) return i;
  }
  return -1;
}

int width_for(int dk) {
  if (width_index(dk) >= 0) return kWidths[width_index(dk)];
  return dk <= kWide ? kWide : 0;
}

// A row a lane owns (its query row, or its key's row) in the long
// backward: held in registers up to W 32, read from shared memory beyond
// (registers for two such rows and two accumulators would not fit).
template <int W, bool REG = (W <= 32)>
struct LaneRow {
  float r[REG ? W : 1];
  const float* p;
  __device__ __forceinline__ void load(const float* src) {
    p = src;
    if constexpr (REG) row_from_smem<W>(r, src);
  }
  __device__ __forceinline__ float dot(const float* __restrict__ b) const {
    if constexpr (REG) {
      return dot_rs<W>(r, b);
    } else {
      return dot_ss<W>(p, b);
    }
  }
};

// At L <= kShortL each warp of the block owns one unit; beyond, the block's
// warps share one unit and take its 32-row chunks in turn.
template <int W, bool VEC, typename T>
__global__ void __launch_bounds__(kMaxGroup * 32, 1)
msa_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const unsigned char* __restrict__ mask,
                         T* __restrict__ out, int units, int H, int L, int dk, int rs, int hs,
                         float scale) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const bool shared = L > kShortL;
  const int unit = shared ? blockIdx.x : blockIdx.x * warps + warp;
  if (unit >= units) return;  // only where each warp owns a unit
  const int t = shared ? threadIdx.x : lane, threads = shared ? blockDim.x : 32;
  // k and v are only read as broadcasts: rows W floats apart
  float* Ks = reinterpret_cast<float*>(smem4) + (shared ? 0 : warp * fwd_warp_floats(L, W));
  float* Vs = Ks + L * W;                                               // [L][W]
  unsigned char* keep = reinterpret_cast<unsigned char*>(Vs + L * W);   // [L]
  const int n = unit / H, h = unit - n * H;
  const size_t base = size_t(n) * L * rs + size_t(h) * hs;
  load_rows<W, W, VEC>(Ks, k + base, L, dk, rs, t, threads);
  load_rows<W, W, VEC>(Vs, v + base, L, dk, rs, t, threads);
  load_keep(keep, mask, n, L, t, threads);
  if constexpr (VEC) cp_async_wait_all();
  if (shared) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  for (int i0 = shared ? 32 * warp : 0; i0 < L; i0 += shared ? 32 * warps : 32) {
    const int i = i0 + lane;
    float qr[W], acc[W];
    row_from_global<W, VEC>(qr, q + base + size_t(min(i, L - 1)) * rs, dk);
    zero<W>(acc);
    float m = -INFINITY, sum = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      float s[kTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        const int j = j0 + jj;
        float x = -INFINITY;  // past L: counts exactly 0
        if (j < L) x = keep[j] ? dot_rs<W>(qr, Ks + j * W) * scale : kMaskFill;
        s[jj] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m, tile_max);  // finite: tile 0 holds key 0
      const float corr = expf(m - m_new);
      sum *= corr;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] *= corr;
      m = m_new;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        const int j = j0 + jj;
        if (j < L) {
          const float e = expf(s[jj] - m_new);
          sum += e;
          axpy<W>(acc, e, Vs + j * W);
        }
      }
    }
    if (i < L) {
      const float inv = 1.f / sum;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] *= inv;
      store_row<W, VEC>(out + base + size_t(i) * rs, acc, dk, hs);
    }
  }
}

// the backward at L <= 32: a warp per unit, scores stored in P and S
template <int W, bool VEC, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
msa_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const unsigned char* __restrict__ mask,
                         const T* __restrict__ dout, T* __restrict__ dq,
                         T* __restrict__ dk_out, T* __restrict__ dv_out, int units, int H,
                         int L, int dk, int rs, int hs, float scale) {
  constexpr int KS = kv_stride(W);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * (blockDim.x >> 5) + warp;
  if (unit >= units) return;
  float* Qs = reinterpret_cast<float*>(smem4) + warp * bwd_warp_floats(L, W);  // [L][KS]
  float* Ds = Qs + L * KS;                                                      // [L][KS]: do
  float* Ks = Ds + L * KS;                                                      // [L][KS]
  float* Vs = Ks + L * KS;                                                      // [L][KS]
  float* P = Vs + L * KS;  // [L][32]: s, then e, then p (swizzled, see sw)
  float* S = P + 32 * L;   // [L][32]: dp, then ds
  unsigned char* keep = reinterpret_cast<unsigned char*>(S + 32 * L);  // [L]
  const int n = unit / H, h = unit - n * H;
  const size_t base = size_t(n) * L * rs + size_t(h) * hs;
  load_rows<W, KS, VEC>(Qs, q + base, L, dk, rs, lane, 32);
  load_rows<W, KS, VEC>(Ds, dout + base, L, dk, rs, lane, 32);
  load_rows<W, KS, VEC>(Ks, k + base, L, dk, rs, lane, 32);
  load_rows<W, KS, VEC>(Vs, v + base, L, dk, rs, lane, 32);
  load_keep(keep, mask, n, L, lane, 32);
  if constexpr (VEC) cp_async_wait_all();
  __syncwarp();
  const int i = min(lane, L - 1);  // lanes past L redo row L - 1, unused
  // ---- pass 1, lane per query row ----
  float m = -INFINITY;
  {
    float qr[W];
    row_from_smem<W>(qr, Qs + i * KS);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float x = keep[j] ? dot_rs<W>(qr, Ks + j * KS) * scale : kMaskFill;
      P[sw(j, lane)] = x;
      m = fmaxf(m, x);
    }
  }
  float sum = 0.f, tu = 0.f;
  {
    float dr[W];
    row_from_smem<W>(dr, Ds + i * KS);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float e = expf(P[sw(j, lane)] - m);
      const float dp = dot_rs<W>(dr, Vs + j * KS);
      P[sw(j, lane)] = e;
      S[sw(j, lane)] = dp;
      sum += e;
      tu = fmaf(e, dp, tu);
    }
  }
  const float inv = 1.f / sum;
  const float t = tu * inv;
  {
    float g[W];
    zero<W>(g);
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float p = P[sw(j, lane)] * inv;
      const float ds = keep[j] ? p * (S[sw(j, lane)] - t) * scale : 0.f;
      P[sw(j, lane)] = p;
      S[sw(j, lane)] = ds;
      axpy<W>(g, ds, Ks + j * KS);
    }
    if (lane < L) store_row<W, VEC>(dq + base + size_t(lane) * rs, g, dk, hs);
  }
  __syncwarp();
  // ---- pass 2, lane per key: the rows in order ----
  if (lane < L) {
    float gk[W], gv[W];
    zero<W>(gk);
    zero<W>(gv);
    for (int r = 0; r < L; ++r) {
      axpy<W>(gk, S[sw(lane, r)], Qs + r * KS);
      axpy<W>(gv, P[sw(lane, r)], Ds + r * KS);
    }
    store_row<W, VEC>(dk_out + base + size_t(lane) * rs, gk, dk, hs);
    store_row<W, VEC>(dv_out + base + size_t(lane) * rs, gv, dk, hs);
  }
}

// the backward at L > 32: a block of up to kMaxGroup warps per unit, the
// scores recomputed, dk and dv by the transposed pass
template <int W, bool VEC, typename T>
__global__ void __launch_bounds__(kMaxGroup * 32, 1)
msa_attention_bwd_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* __restrict__ mask,
                              const T* __restrict__ dout, T* __restrict__ dq,
                              T* __restrict__ dk_out, T* __restrict__ dv_out, int units,
                              int H, int L, int dk, int rs, int hs, float scale) {
  constexpr int KS = kv_stride(W);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = blockDim.x >> 5;
  float* Qs = reinterpret_cast<float*>(smem4);  // [L][KS]
  float* Ds = Qs + L * KS;                      // [L][KS]: do
  float* Ks = Ds + L * KS;                      // [L][KS]
  float* Vs = Ks + L * KS;                      // [L][KS]
  float* M = Vs + L * KS;                       // [L]: each row's max,
  float* R = M + L;                             // 1 / sum of exp(s - max)
  float* Ts = R + L;                            // and t
  unsigned char* keep = reinterpret_cast<unsigned char*>(Ts + L);  // [L]
  const int unit = blockIdx.x;
  const int n = unit / H, h = unit - n * H;
  const size_t base = size_t(n) * L * rs + size_t(h) * hs;
  load_rows<W, KS, VEC>(Qs, q + base, L, dk, rs, threadIdx.x, blockDim.x);
  load_rows<W, KS, VEC>(Ds, dout + base, L, dk, rs, threadIdx.x, blockDim.x);
  load_rows<W, KS, VEC>(Ks, k + base, L, dk, rs, threadIdx.x, blockDim.x);
  load_rows<W, KS, VEC>(Vs, v + base, L, dk, rs, threadIdx.x, blockDim.x);
  load_keep(keep, mask, n, L, threadIdx.x, blockDim.x);
  if constexpr (VEC) cp_async_wait_all();
  __syncthreads();
  // ---- part 1, lane per query row: row statistics, then dq ----
  for (int i0 = 32 * warp; i0 < L; i0 += 32 * group) {
    const int i = min(i0 + lane, L - 1);  // lanes past L redo row L - 1, unused
    LaneRow<W> qi, di;
    qi.load(Qs + i * KS);
    di.load(Ds + i * KS);
    float m = -INFINITY, z = 0.f, tu = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      float s[kTile], dp[kTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        const int j = j0 + jj;
        float x = -INFINITY, y = 0.f;  // past L: counts exactly 0
        if (j < L) {
          x = keep[j] ? qi.dot(Ks + j * KS) * scale : kMaskFill;
          y = di.dot(Vs + j * KS);
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
    float g[W];
    zero<W>(g);
#pragma unroll 2
    for (int j = 0; j < L; ++j) {
      if (keep[j]) {  // a masked key has ds 0
        const float p = expf(qi.dot(Ks + j * KS) * scale - m) * inv;
        axpy<W>(g, p * (di.dot(Vs + j * KS) - t) * scale, Ks + j * KS);
      }
    }
    if (i0 + lane < L) {
      M[i] = m;
      R[i] = inv;
      Ts[i] = t;
      store_row<W, VEC>(dq + base + size_t(i) * rs, g, dk, hs);
    }
  }
  __syncthreads();
  // ---- part 2, lane per key: dk and dv over the rows in order ----
  for (int j0 = 32 * warp; j0 < L; j0 += 32 * group) {
    const int j = min(j0 + lane, L - 1);  // lanes past L redo key L - 1, unused
    LaneRow<W> kj, vj;
    kj.load(Ks + j * KS);
    vj.load(Vs + j * KS);
    const bool kept = keep[j];
    float gk[W], gv[W];
    zero<W>(gk);
    zero<W>(gv);
#pragma unroll 2
    for (int r = 0; r < L; ++r) {
      const float x = kept ? kj.dot(Qs + r * KS) * scale : kMaskFill;
      const float p = expf(x - M[r]) * R[r];
      const float ds = kept ? p * (vj.dot(Ds + r * KS) - Ts[r]) * scale : 0.f;
      axpy<W>(gk, ds, Qs + r * KS);
      axpy<W>(gv, p, Ds + r * KS);
    }
    if (j0 + lane < L) {
      store_row<W, VEC>(dk_out + base + size_t(j) * rs, gk, dk, hs);
      store_row<W, VEC>(dv_out + base + size_t(j) * rs, gv, dk, hs);
    }
  }
}

template <bool VEC, typename T>
FwdKernel<T> fwd_kernel(int W) {
  switch (W) {
    case 8: return msa_attention_fwd_kernel<8, VEC, T>;
    case 16: return msa_attention_fwd_kernel<16, VEC, T>;
    case 20: return msa_attention_fwd_kernel<20, VEC, T>;
    case 24: return msa_attention_fwd_kernel<24, VEC, T>;
    case 32: return msa_attention_fwd_kernel<32, VEC, T>;
    case 48: return msa_attention_fwd_kernel<48, VEC, T>;
    case 64: return msa_attention_fwd_kernel<64, VEC, T>;
    default: return nullptr;
  }
}

// one backward kernel; a file instantiates only the kind (LONG or not) it
// launches
template <int W, bool VEC, bool LONG, typename T>
BwdKernel<T> bwd_kernel_of() {
  if constexpr (LONG) {
    return msa_attention_bwd_long_kernel<W, VEC, T>;
  } else {
    return msa_attention_bwd_kernel<W, VEC, T>;
  }
}

template <bool VEC, bool LONG, typename T>
BwdKernel<T> bwd_kernel(int W) {
  switch (W) {
    case 8: return bwd_kernel_of<8, VEC, LONG, T>();
    case 16: return bwd_kernel_of<16, VEC, LONG, T>();
    case 20: return bwd_kernel_of<20, VEC, LONG, T>();
    case 24: return bwd_kernel_of<24, VEC, LONG, T>();
    case 32: return bwd_kernel_of<32, VEC, LONG, T>();
    case 48: return bwd_kernel_of<48, VEC, LONG, T>();
    case 64: return bwd_kernel_of<64, VEC, LONG, T>();
    default: return nullptr;
  }
}

// rows of four-element groups: the strides multiples of 4 and every
// pointer aligned to four elements (16 bytes fp32, 8 bytes bf16)
bool vector_path(const void* const* ptrs, int count, int rs, int hs, size_t elem) {
  bool ok = rs % 4 == 0 && hs % 4 == 0;
  for (int a = 0; a < count; ++a) ok = ok && reinterpret_cast<uintptr_t>(ptrs[a]) % (4 * elem) == 0;
  return ok;
}

int lesser(int a, int b) { return a < b ? a : b; }

// warps per block (1..kMaxWarps) of independent warps for the most warps
// resident per SM, by shared memory, registers (allocated 256 a warp), at
// most 32 blocks and 64 warps; the larger block on a tie; 0 if not one warp
// fits a block. ops/msa_attention.py's `warps_per_block` is the same rule.
int warps_per_block(size_t warp_bytes, int regs) {
  const int warp_regs = (regs + 7) / 8 * 8 * 32;
  const int reg_warps = g_sm_regs / warp_regs;
  int best = 0, best_resident = 0;
  for (int w = 1; w <= kMaxWarps; ++w) {
    const size_t block = w * warp_bytes;
    if (block > size_t(g_max_smem)) break;
    const int by_smem = int(size_t(g_sm_smem) / (block + kBlockReserve));
    const int blocks = lesser(lesser(by_smem, reg_warps / w), lesser(32, 64 / w));
    if (blocks * w >= best_resident) {
      best = w;
      best_resident = blocks * w;
    }
  }
  return best;
}

bool bad_geometry(int N, int H, int L, int dk, int rs, int hs) {
  return N <= 0 || H <= 0 || L <= 0 || dk <= 0 || hs < dk || rs < H * hs ||
         size_t(N) * H > size_t(INT_MAX) || width_for(dk) == 0;
}


// ---------------------------------------------------------------------------
// The entry points' logic for element type T: each kernel file's C functions
// call these (its own copy of the globals above, set by its own init).
// ---------------------------------------------------------------------------
template <typename T>
cudaError_t init_impl() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_sm_regs, cudaDevAttrMaxRegistersPerMultiprocessor, dev);
  }
  for (int i = 0; i < kNumWidths; ++i) {
    const int w = kWidths[i];
    const void* kernels[2][2] = {
        {reinterpret_cast<const void*>(fwd_kernel<false, T>(w)),
         reinterpret_cast<const void*>(fwd_kernel<true, T>(w))},
        {reinterpret_cast<const void*>(bwd_kernel<false, false, T>(w)),
         reinterpret_cast<const void*>(bwd_kernel<true, false, T>(w))},
    };
    for (int kind = 0; kind < 2; ++kind) {
      for (int vec = 0; vec < 2; ++vec) {
        cudaFuncAttributes attr;
        if (e == cudaSuccess) {
          e = cudaFuncSetAttribute(kernels[kind][vec],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
        }
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernels[kind][vec]);
        if (e == cudaSuccess) g_regs[kind][vec][i] = attr.numRegs;
      }
    }
  }
  if (e == cudaSuccess) e = digat::attention_long_init<T>(g_max_smem);
  if (e == cudaSuccess) e = digat::attention_wide_init<T>(g_max_smem);
  return e;
}

// out [N, L, rs] from q, k, v [N, L, rs] and the optional key mask [N, L]
// (bytes, nonzero = keep; null = keep all).
template <typename T>
cudaError_t fwd_impl(const void* q, const void* k, const void* v, const void* mask, void* out,
                     int N, int H, int L, int dk, int rs, int hs, float scale,
                     cudaStream_t stream) {
  if (bad_geometry(N, H, L, dk, rs, hs)) return cudaErrorInvalidValue;
  const int W = width_for(dk);
  const void* ptrs[] = {q, k, v, out};
  const bool vec = vector_path(ptrs, 4, rs, hs, sizeof(T));
  const T *pq = static_cast<const T*>(q), *pk = static_cast<const T*>(k),
          *pv = static_cast<const T*>(v);
  const unsigned char* pm = static_cast<const unsigned char*>(mask);
  T* po = static_cast<T*>(out);
  if (W == kWide) {
    return digat::attention_fwd_wide<T>(pq, pk, pv, pm, po, N, H, L, dk, rs, hs, scale, vec,
                                         g_max_smem, stream);
  }
  const size_t unit_bytes = sizeof(float) * fwd_warp_floats(L, W);
  const int units = N * H;
  int blocks = units, warps = lesser(kMaxGroup, (L + 31) / 32);
  if (unit_bytes > size_t(g_max_smem)) return cudaErrorInvalidValue;
  if (L <= kShortL) {
    warps = warps_per_block(unit_bytes, g_regs[0][vec][width_index(dk)]);
    blocks = (units + warps - 1) / warps;
  }
  const FwdKernel<T> kern = vec ? fwd_kernel<true, T>(W) : fwd_kernel<false, T>(W);
  kern<<<blocks, 32 * warps, (L <= kShortL ? warps : 1) * unit_bytes, stream>>>(
      pq, pk, pv, pm, po, units, H, L, dk, rs, hs, scale);
  return cudaGetLastError();
}

// dq, dk, dv [N, L, rs] from q, k, v, the mask and the output gradient do.
template <typename T>
cudaError_t bwd_impl(const void* q, const void* k, const void* v, const void* mask,
                     const void* dout, void* dq, void* dk_out, void* dv_out, int N, int H, int L,
                     int dk, int rs, int hs, float scale, cudaStream_t stream) {
  if (bad_geometry(N, H, L, dk, rs, hs)) return cudaErrorInvalidValue;
  const int W = width_for(dk);
  const void* ptrs[] = {q, k, v, dout, dq, dk_out, dv_out};
  const bool vec = vector_path(ptrs, 7, rs, hs, sizeof(T));
  const int units = N * H;
  int blocks = units, threads = 0;
  size_t smem = 0;
  BwdKernel<T> kern = nullptr;
  if (W == kWide) {
    return digat::attention_bwd_wide<T>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<T*>(dk_out), static_cast<T*>(dv_out), N, H, L, dk, rs, hs, scale, vec,
        g_max_smem, stream);
  }
  if (L <= kShortL) {
    const size_t warp_bytes = sizeof(float) * bwd_warp_floats(L, W);
    const int warps = warps_per_block(warp_bytes, g_regs[1][vec][width_index(dk)]);
    if (warps == 0) return cudaErrorInvalidValue;
    kern = vec ? bwd_kernel<true, false, T>(W) : bwd_kernel<false, false, T>(W);
    blocks = (units + warps - 1) / warps;
    threads = 32 * warps;
    smem = warps * warp_bytes;
  } else {
    return digat::attention_bwd_long<T>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<T*>(dk_out), static_cast<T*>(dv_out), N, H, L, dk, rs, hs, scale, vec,
        g_max_smem, stream);
  }
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), units, H, L, dk, rs, hs, scale);
  return cudaGetLastError();
}

}  // namespace

#ifdef DIGAT_ATTENTION_LONG
namespace digat {

template <typename T>
cudaError_t attention_long_init(int max_smem) {
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < kNumWidths && e == cudaSuccess; ++i) {
    const void* kernels[2] = {reinterpret_cast<const void*>(bwd_kernel<false, true, T>(kWidths[i])),
                              reinterpret_cast<const void*>(bwd_kernel<true, true, T>(kWidths[i]))};
    for (int vec = 0; vec < 2 && e == cudaSuccess; ++vec)
      e = cudaFuncSetAttribute(kernels[vec], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
  }
  return e;
}

// a block of up to kMaxGroup warps a unit
template <typename T>
cudaError_t attention_bwd_long(const T* q, const T* k, const T* v, const unsigned char* mask,
                               const T* dout, T* dq, T* dk_out, T* dv_out, int N, int H, int L,
                               int dk, int rs, int hs, float scale, bool vec, int max_smem,
                               cudaStream_t stream) {
  const int W = width_for(dk), units = N * H;
  const size_t smem = sizeof(float) * bwd_long_floats(L, W);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  const BwdKernel<T> kern = vec ? bwd_kernel<true, true, T>(W) : bwd_kernel<false, true, T>(W);
  kern<<<units, 32 * lesser(kMaxGroup, (L + 31) / 32), smem, stream>>>(
      q, k, v, mask, dout, dq, dk_out, dv_out, units, H, L, dk, rs, hs, scale);
  return cudaGetLastError();
}

}  // namespace digat
#endif  // DIGAT_ATTENTION_LONG
