// Helpers shared by the port's kernels: warp reductions, and one tiled fp32
// GEMM on the CUDA cores, which the GAT layer's projections use
// (gat_layer.cu).
//
// The GEMM: C (+ bias) = A[M, K] B[N, K]^T, A row-major and B an nn.Linear
// weight ([out, in]) whose rows may come from up to three arrays stacked.
// 64x64 output tiles, 16-deep k steps, 256 threads each owning 4x4 outputs
// read from shared memory as float4. Tiles are loaded with neighbouring
// threads on neighbouring addresses of the stored matrix; each thread's
// stored rows of A and B are fixed, so their pointers are computed once,
// before the k loop. A stacked row's array is picked by compares and
// selects: a division costs about 20 instructions, and a runtime index into
// a kernel's parameter struct copies the struct to local memory. Sums run
// over k in order, then the bias is added: the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace digat {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16;

// A row-major matrix whose rows may come from up to three arrays stacked:
// stored row r is p[r / rows] + (r % rows) * ld.
struct Mat {
  const float* p[3];
  int rows;
  int ld;
};

// One array of `ld` columns.
inline Mat mat1(const float* p, int ld) { return Mat{{p, p, p}, INT_MAX, ld}; }

__device__ __forceinline__ const float* mat_row(const Mat& m, int r) {
  const bool s1 = r >= m.rows, s2 = r - m.rows >= m.rows;  // r / rows for r < 3 * rows
  const float* p = s2 ? m.p[2] : (s1 ? m.p[1] : m.p[0]);
  return p + (size_t)(r - (int(s1) + int(s2)) * m.rows) * m.ld;
}

// bias[n] = p[n / len][n % len], or 0 where that pointer is null or len is 0
struct Bias {
  const float* p[3];
  int len;
};

// static: each source that includes this header has its own copy
static __global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(Mat A, Mat B, Bias bias, float* __restrict__ C, int M, int N, int K) {
  constexpr int BM = kGemmBM, BN = kGemmBN, BK = kGemmBK, T = kGemmThreads;
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN + 4];  // B^T tile, k-major
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // outputs rows ty*4.., cols tx*4..
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // the stored rows of A and B this thread loads: fixed for the whole k loop
  const float* arow[4];
  const float* brow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = tid + r * T;
    arow[r] = nullptr;
    brow[r] = nullptr;
    if (m0 + e / BK < M) arow[r] = mat_row(A, m0 + e / BK);
    if (n0 + e / BK < N) brow[r] = mat_row(B, n0 + e / BK);
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * T;
      const int mm = e / BK, kk = e % BK, gk = k0 + kk;
      As[kk][mm] = (arow[r] != nullptr && gk < K) ? arow[r][gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * T;
      const int nn = e / BK, kk = e % BK, gk = k0 + kk;
      Bs[kk][nn] = (brow[r] != nullptr && gk < K) ? brow[r][gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float b = 0.f;
      if (bias.len > 0) {
        const bool s1 = gn >= bias.len, s2 = gn - bias.len >= bias.len;
        const float* bp = s2 ? bias.p[2] : (s1 ? bias.p[1] : bias.p[0]);
        if (bp != nullptr) b = bp[gn - (int(s1) + int(s2)) * bias.len];
      }
      C[(size_t)gm * N + gn] = acc[i][j] + b;
    }
  }
}

// Launches gemm_kernel on `st`. Returns the launch's error.
inline cudaError_t gemm(cudaStream_t st, Mat A, Mat B, Bias bias, float* C, int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_kernel<<<grid, kGemmThreads, 0, st>>>(A, B, bias, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace digat
