// Matrix products on the tensor cores for sm_90a, fp32 at 3xTF32: the
// products of the MSA encoder's forward (msa_encoder.cu, kernel A) and
// backward (msa_encoder_bwd.cu, kernel A') and the eval GAT layer's
// projections (gat_layer.cu, kernel B), each in its fp32 instance.
//
// C[z] = op(A)[M, K_z] op(B)[K_z, N] over the z-th slice of K
// (k_per_split rows each), then an epilogue (bias, tanh pool with its
// v-product, that v-product alone, the ReLU-masked pool gradient, or the
// word-dropout mask).
// A is "K-major" when its rows run along K (A[m][k], lda >= K) and
// "M-major" when stored transposed (A[k][m]); B is K-major when stored
// [N][K] (an nn.Linear weight) and N-major when stored [K][N].
//
// 3xTF32. A TF32 operand keeps 10 mantissa bits; a single pass misses an
// fp32 gate of 1e-4 at K = 1,200. Each element x is split once, as it
// enters shared memory, into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (cvt.rna.tf32.f32: round to nearest, ties away from zero), and every
// product is summed as lo*hi + hi*lo + hi*hi into fp32 registers; the
// dropped lo*lo term is below 2^-22 of |a b|, so the sum keeps fp32-class
// accuracy (tests/test_torch_tf32x3.py replays the split on the CPU).
//
// Route: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, simple and
// right first. The split has to touch every element once before the
// tensor cores read it, so the k-tiles pass through registers: the float4
// loads of tile kt + 1 are issued before the products of tile kt, then
// split and stored into the other of two shared-memory stages of hi and lo.
// (A ring of three raw stages filled by cp.async, with a split pass per
// tile, ran about 9 % slower: one more barrier a tile and only one stage of
// hi and lo.) Near the mma.sync ceiling the next step is wgmma with TMA,
// which reads only K-major TF32 operands, so the split pass would also
// transpose.
//
// Tiles: 128 x BN outputs (BN 96, 128 or 160) and 32-deep k-steps per block of
// 256 threads; 8 warps as 2 (m) x 4 (n), each 64 x BN/4. Shared rows are
// padded (K-major rows 36 floats, M- or N-major rows BM/BN + 8) so that a
// warp's fragment loads hit 32 different banks. One block per SM (about
// 150-170 KB of shared memory for two stages of hi and lo).
//
// Sums run over k in order within a slice, and the slices' partials are
// written apart and summed by the caller in slice order: the same bits on
// every run, no atomics.
//
// The output C may be bf16 (TC), rounded once to nearest even in the
// epilogue. (The bf16 instances' products run on wgmma: tc_wgmma.cuh.)
//
// Rounding of the sums (kRN). The tensor cores add each product into the
// fp32 accumulator rounding toward zero, not to nearest (the TF32 and the
// bf16 instruction alike, scripts/mma_rounding.py on an H100), so over K 300 the
// 114 accumulations of the three passes drift one way: emulated, the sum is
// about 9 times further from the exact value (RMS) than an fp32 CUDA-core
// product, where 3xTF32 rounded to nearest would be as close
// (tests/test_torch_msa_fwd_chain.py). With kRN each 32-deep k-tile's
// products accumulate into fresh registers, which are then added to the
// running sum on the CUDA cores, rounding to nearest: about as close as an
// fp32 CUDA-core product, for one add per accumulator a tile and as many
// registers again. The products of kernels A, A' and B take kRN, at tiles
// 96 wide.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace digat {
namespace tc {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBK = 32, kWM = 64, kMT = kWM / 16;

enum Epilogue : int {
  kStore = 0,  // C = acc (split-K partial z at C + z * M * N)
  kBias = 1,   // C = acc + bias[n]
  kPool = 2,   // C = u = tanh(acc + bias[n]); lgpart[part][m] = sum over a warp's columns
               // of u * v[n]
  kDh = 3,     // C = (acc + alpha[m] * dp[m / title][n]) * (h[m][n] > 0)
  kDrop = 4,   // C = keep(m, n) ? acc * drop_scale : 0 (the word-dropout mask of title m / title)
  kLogits = 5,  // lgpart as kPool, and C not written (C may be null)
};

// A and B point at fp32, C at fp32 or at bf16 where the instance takes it (TC)
struct Args {
  const void* A;
  const void* B;
  void* C;
  int M, N, K, lda, ldb, ldc, k_per_split;
  const float* bias;    // kBias, kPool, kLogits: [N]
  const float* v;       // kPool, kLogits: [N]
  float* lgpart;        // kPool, kLogits: [gridDim.x * 4, M]
  const float* alpha;   // kDh: [M]
  const float* dp;      // kDh: [M / title, N]
  const float* h;       // kDh: [M, ldc]
  uint32_t thresh, seed, site;  // kDrop
  float drop_scale;             // kDrop
  int title;                    // kDh, kDrop: rows of one title (its length L)
};

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// title t and position pos of row `row` for titles of `title` rows (a
// shift at the production length 32, where a division by a run-time value
// would cost its epilogue 5-8 %)
__device__ __forceinline__ void title_row(int row, int title, int& t, int& pos) {
  t = title == 32 ? row >> 5 : row / title;
  pos = row - t * title;
}

__device__ __forceinline__ void split4(const float4 x, uint4& hi, uint4& lo) {
  hi.x = rna_tf32(x.x);
  hi.y = rna_tf32(x.y);
  hi.z = rna_tf32(x.z);
  hi.w = rna_tf32(x.w);
  lo.x = rna_tf32(x.x - __uint_as_float(hi.x));
  lo.y = rna_tf32(x.y - __uint_as_float(hi.y));
  lo.z = rna_tf32(x.z - __uint_as_float(hi.z));
  lo.w = rna_tf32(x.w - __uint_as_float(hi.w));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Floats of one shared tile, hi or lo: K-major rows are kBK + 4 apart, M- or
// N-major rows `width + 8` apart.
__host__ __device__ constexpr int tile_floats(bool kmajor, int width) {
  return kmajor ? width * (kBK + 4) : kBK * (width + 8);
}

template <bool AK, bool BK, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * 4 * (2 * tile_floats(AK, kBM) + 2 * tile_floats(BK, BN));  // 2 stages of hi, lo
}

// Offset in a shared tile (padded layout) of the thread's i-th float4 of a
// k-tile, and that float4's (row, k) in the tile: W rows by 32 k.
template <bool KM, int W>
__device__ __forceinline__ int tile_slot(int i, int& rr, int& kk) {
  const int e = threadIdx.x + i * kThreads;
  if (KM) {  // W rows of 32 k: 8 float4 a row
    rr = e >> 3;
    kk = (e & 7) * 4;
    return rr * (kBK + 4) + kk;
  }
  kk = e / (W / 4);  // 32 k rows of W: W / 4 float4 a row
  rr = (e - kk * (W / 4)) * 4;
  return kk * (W + 8) + rr;
}

// The thread's groups of 4 elements of a k-tile into registers as float4s
// (zero past the matrix's rows or the slice's k).
template <bool KM, int W>
__device__ __forceinline__ void load_tile(float4 (&r)[W * kBK / 4 / kThreads], const float* p,
                                          int ld, int rows, int r0, int k0, int kend) {
#pragma unroll
  for (int i = 0; i < W * kBK / 4 / kThreads; ++i) {
    int rr, kk;
    tile_slot<KM, W>(i, rr, kk);
    const int gr = r0 + rr, gk = k0 + kk;
    r[i] = gr < rows && gk < kend
               ? digat::load4(p + (KM ? (size_t)gr * ld + gk : (size_t)gk * ld + gr))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The same float4s split into hi and lo, each element once, into a stage.
template <bool KM, int W>
__device__ __forceinline__ void store_tile(const float4 (&r)[W * kBK / 4 / kThreads],
                                           uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < W * kBK / 4 / kThreads; ++i) {
    int rr, kk;
    const int off = tile_slot<KM, W>(i, rr, kk);
    uint4 h, l;
    split4(r[i], h, l);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// element (row r, k c) of a shared tile
template <bool KM, int W>
__device__ __forceinline__ int at(int r, int c) {
  return KM ? r * (kBK + 4) + c : c * (W + 8) + r;
}

// The epilogue of a block's 128 x BN outputs: the thread holds rows g, g + 8
// and columns 2t, 2t + 1 of each 16 x 8 tile of its warp's 64 x BN/4.
template <int EPI, int NT, typename TC>
__device__ __forceinline__ void epilogue(const Args& p, const float (&acc)[kMT][NT][4], int m0,
                                         int n0, int wm, int wn, int g, int t) {
  constexpr int WN = NT * 8;
  TC* C = static_cast<TC*>(p.C) + (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWM + i * 16 + g + half * 8;
      const bool row_in = row < p.M;
      int tt = 0, pos = 0;  // the row's title and position in it (kDh, kDrop)
      if (EPI == kDh || EPI == kDrop) title_row(row, p.title, tt, pos);
      float lg = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * t;
        if (!row_in || col >= p.N) continue;  // N is a multiple of 4: col + 1 < N too
        float2 val = make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        if (EPI == kBias) {
          val.x += __ldg(p.bias + col);
          val.y += __ldg(p.bias + col + 1);
        } else if (EPI == kPool || EPI == kLogits) {
          val.x = tanhf(val.x + __ldg(p.bias + col));
          val.y = tanhf(val.y + __ldg(p.bias + col + 1));
          lg = fmaf(val.x, __ldg(p.v + col), lg);
          lg = fmaf(val.y, __ldg(p.v + col + 1), lg);
        } else if (EPI == kDh) {
          // read-only loads: the compiler may issue them ahead of the stores
          const float a = __ldg(p.alpha + row);
          const float2 d = __ldg(reinterpret_cast<const float2*>(
              p.dp + (size_t)tt * p.N + col));
          const float2 h = __ldg(reinterpret_cast<const float2*>(p.h + (size_t)row * p.ldc + col));
          val.x = h.x > 0.f ? fmaf(a, d.x, val.x) : 0.f;
          val.y = h.y > 0.f ? fmaf(a, d.y, val.y) : 0.f;
        } else if (EPI == kDrop) {
          const int flat = pos * p.N + col;  // col even, N % 4 == 0: one group
          const Philox4 d = dropout_draws(uint32_t(tt), uint32_t(flat >> 2), p.seed, p.site);
          const uint32_t d0 = (flat & 3) ? d.z : d.x, d1 = (flat & 3) ? d.w : d.y;
          val.x = dropout_value(val.x, d0, p.thresh, p.drop_scale);
          val.y = dropout_value(val.y, d1, p.thresh, p.drop_scale);
        }
        if (EPI != kLogits) digat::store2(C + (size_t)row * p.ldc + col, val);
      }
      if (EPI == kPool || EPI == kLogits) {  // the v-product over this warp's WN columns, one
                                             // part per warp column
        lg += __shfl_xor_sync(0xffffffffu, lg, 1);
        lg += __shfl_xor_sync(0xffffffffu, lg, 2);
        if (t == 0 && row_in) p.lgpart[(size_t)(blockIdx.x * 4 + wn) * p.M + row] = lg;
      }
    }
  }
}

// A and B fp32 (3xTF32); C fp32 or bf16 (TC).
template <bool AK, bool BK, int BN, int EPI, bool kRN = false, typename TC = float>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(Args p) {
  constexpr int WN = BN / 4, NT = WN / 8;
  constexpr int AT = tile_floats(AK, kBM), BT = tile_floats(BK, BN);
  constexpr int STAGE = 2 * AT + 2 * BT;  // A hi, A lo, B hi, B lo
  static_assert(BN * kBK % (4 * kThreads) == 0 && WN % 8 == 0, "tile shape");
  extern __shared__ float4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const float* Ap = static_cast<const float*>(p.A);
  const float* Bp = static_cast<const float*>(p.B);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_per_split;
  const int kend = min(p.K, kbeg + p.k_per_split);
  const int ntiles = (kend - kbeg + kBK - 1) / kBK;

  // the running sums, and the registers the products accumulate into: a
  // k-tile's own (kRN; without kRN `part` is never used and takes none) or
  // the running sums
  float acc[kMT][NT][4], part[kMT][NT][4];
  float (&sums)[kMT][NT][4] = kRN ? part : acc;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // k-tile kt + 1 is loaded into registers while the products run on tile
  // kt, then split into the other stage
  float4 ra[kBM * kBK / 4 / kThreads], rb[BN * kBK / 4 / kThreads];
  load_tile<AK, kBM>(ra, Ap, p.lda, p.M, m0, kbeg, kend);
  load_tile<BK, BN>(rb, Bp, p.ldb, p.N, n0, kbeg, kend);
  store_tile<AK, kBM>(ra, sm, sm + AT);
  store_tile<BK, BN>(rb, sm + 2 * AT, sm + 2 * AT + BT);
  __syncthreads();
  for (int kt = 0; kt < ntiles; ++kt) {
    const bool more = kt + 1 < ntiles;
    if (more) {
      load_tile<AK, kBM>(ra, Ap, p.lda, p.M, m0, kbeg + (kt + 1) * kBK, kend);
      load_tile<BK, BN>(rb, Bp, p.ldb, p.N, n0, kbeg + (kt + 1) * kBK, kend);
    }
    if (kRN) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) sums[i][j][c] = 0.f;
    }
    const uint32_t* st = sm + (kt & 1) * STAGE;
    const uint32_t *ahi = st, *alo = st + AT, *bhi = st + 2 * AT, *blo = st + 2 * AT + BT;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[kMT][4], al[kMT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm * kWM + i * 16 + g;
        const int o[4] = {at<AK, kBM>(r, kk + t), at<AK, kBM>(r + 8, kk + t),
                          at<AK, kBM>(r, kk + t + 4), at<AK, kBM>(r + 8, kk + t + 4)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[i][c] = ahi[o[c]];
          al[i][c] = alo[o[c]];
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * WN + j * 8 + g;
        const int o0 = at<BK, BN>(n, kk + t), o1 = at<BK, BN>(n, kk + t + 4);
        bh[j][0] = bhi[o0];
        bh[j][1] = bhi[o1];
        bl[j][0] = blo[o0];
        bl[j][1] = blo[o1];
      }
      // three passes over the warp's tiles, so that
      // the kMT * NT products of a pass are independent and the next pass
      // finds its accumulator ready
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(sums[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(sums[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(sums[i][j], ah[i], bh[j]);
    }
    if (kRN) {  // the k-tile's sums into the running sums, rounding to nearest
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += sums[i][j][c];
    }
    if (more) {
      uint32_t* d = sm + ((kt + 1) & 1) * STAGE;
      store_tile<AK, kBM>(ra, d, d + AT);
      store_tile<BK, BN>(rb, d + 2 * AT, d + 2 * AT + BT);
    }
    __syncthreads();
  }
  epilogue<EPI, NT, TC>(p, acc, m0, n0, wm, wn, g, t);
}

// Grants the kernel its shared memory on the current device.
template <bool AK, bool BK, int BN, int EPI, bool kRN = false, typename TC = float>
inline cudaError_t init() {
  return cudaFuncSetAttribute(gemm_kernel<AK, BK, BN, EPI, kRN, TC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<AK, BK, BN>());
}

// Parts of kPool's lgpart for N columns at tile width BN.
template <int BN>
__host__ __device__ constexpr int pool_parts(int N) {
  return (N + BN - 1) / BN * 4;
}

// The checks every launch makes, and the grid: N, every leading dimension,
// K where an operand is K-major, and M where A is M-major a multiple of 4,
// and every matrix 16-byte aligned (4-element loads: an M-major or N-major
// operand reads its groups of 4 along M or N and a k-row at a time, so it
// takes any K); false where the shapes are not taken.
template <bool AK, bool BK, int BN>
inline bool plan(const Args& p, dim3& grid) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.k_per_split <= 0 ||
      ((AK ? 0 : p.M) | p.N | (AK || BK ? p.K : 0)) % 4 ||
      (p.lda | p.ldb | p.ldc) % 4 || (reinterpret_cast<uintptr_t>(p.A) |
                                      reinterpret_cast<uintptr_t>(p.B) |
                                      reinterpret_cast<uintptr_t>(p.C)) % 16) {
    return false;
  }
  const int splits = (p.K + p.k_per_split - 1) / p.k_per_split;
  grid = dim3((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM, splits);
  return grid.y <= 65535 && grid.z <= 65535;
}

// Launches gemm_kernel on `st`: ceil(K / k_per_split) slices of K; returns
// the launch's error.
template <bool AK, bool BK, int BN, int EPI, bool kRN = false, typename TC = float>
inline cudaError_t gemm(cudaStream_t st, const Args& p) {
  dim3 grid;
  if (!plan<AK, BK, BN>(p, grid)) return cudaErrorInvalidValue;
  gemm_kernel<AK, BK, BN, EPI, kRN, TC><<<grid, kThreads, smem_bytes<AK, BK, BN>(), st>>>(p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace digat
