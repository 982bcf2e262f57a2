// Fused interactive GAT layer, eval forward, fp32, for sm_90a.
//
// Replaces the TPU kernel digat_tpu/ops/pallas/gat_layer.py
// (interactive_gat_layer_fused -> _layer_kernel). For each graph b:
//
//     h  = x W + bW        k1 = x W1        k2 = x W2        k3 = q W3 + b3
//     s[i, j]  = a . relu(k1[j] + k2[i] + k3)          (Eq. 8 scores)
//     alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
//     out      = relu(alpha h) + x
//
// What bounds it on an H100: arithmetic. At B = 1024, G = 68, D = 400 the
// projections are 2*B*G*D*3D = 67 GFLOP, the score sweep about 4*B*G*G*D =
// 7.6 GFLOP and the aggregation 2*B*G*G*D = 3.8 GFLOP, against about 0.2 GB
// of inputs and outputs: far above the fp32 ridge.
//
// Design, two steps that the one wrapper call launches on the caller's stream:
//   1. gat_layer_project_f32: a tiled fp32 GEMM (64x64 tiles, 16-deep k
//      steps, 4x4 outputs per thread from float4 shared-memory reads) writes
//      y = x [W|W1|W2] + [bW|0|0] ([B*G, 3D]) and, with the same kernel,
//      k3 = q W3 + b3 ([B, D]) into scratch that the wrapper allocates. It
//      reads each weight in nn.Linear layout ([out, in]) through its own
//      pointer, so nothing is packed per call. Full fp32 products, where the
//      TPU ran them at DEFAULT (bf16-pass) precision.
//   2. gat_layer_attend_f32, the rest:
//      one block per graph keeps k1 [G, D] in shared memory with a padded
//      row stride (D+1, so the 32 lanes of a warp, one neighbour j each,
//      read 32 different banks). A warp takes a centre row i, stages
//      k2[i] + k3 in shared memory, and each lane reduces over D for its j,
//      never storing the [G, G, D] sum. Leaky ReLU, the -1e9 mask and the
//      softmax over j follow per row (a row with no neighbour becomes
//      uniform, as in the reference). h then replaces k1 in shared memory
//      and the block writes relu(alpha h) + x.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskFill = -1e9f;

constexpr int BM = 64, BN = 64, BK = 16;

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

// Up to three [rows, K] row-major matrices read as one stacked [N, K] one:
// stacked row n is p[n / rows] + (n % rows) * K.
struct RowSet {
  const float* p[3];
  int rows;
};

// C[M, N] = A[M, K] Bt[N, K]^T + bias[n] for n < nbias (row-major, fp32)
__global__ void __launch_bounds__(kThreads)
sgemm_bias_kernel(const float* __restrict__ A, RowSet Bt, const float* __restrict__ bias,
                  int nbias, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];  // Bt tile, transposed: Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // outputs rows ty*4.., cols tx*4..
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // The Bt rows this thread loads: 16 consecutive threads read one row's k
  // step (64 contiguous bytes).
  const float* brow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gn = n0 + (tid + r * kThreads) / BK;
    brow[r] = gn < N ? Bt.p[gn / Bt.rows] + (size_t)(gn % Bt.rows) * K : nullptr;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * kThreads;
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * kThreads;
      const int nn = e / BK, kk = e % BK;
      const int gk = k0 + kk;
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
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j] + (gn < nbias ? bias[gn] : 0.f);
    }
  }
}

int g_max_smem = 0;  // opt-in shared memory per block, set by gat_layer_init

__host__ __device__ inline size_t layer_smem_floats(int G, int D) {
  return size_t(G) * (D + 1) + size_t(G) * G + size_t(kWarps) * D + D;
}

__global__ void __launch_bounds__(kThreads)
gat_layer_kernel(const float* __restrict__ x,            // [B, G, D]
                 const unsigned char* __restrict__ adj,  // [B, G, G]
                 const float* __restrict__ y,            // [B, G, 3D]: h | k1 | k2
                 const float* __restrict__ k3,           // [B, D]
                 const float* __restrict__ a,            // [D]
                 float* __restrict__ out,                // [B, G, D]
                 int G, int D, float slope) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* T = smem;                 // [G][D+1]: k1 rows, then h rows
  float* S = T + G * Dp;           // [G][G]: scores, then alpha
  float* Cw = S + G * G;           // [kWarps][D]: k2[i] + k3 of the warp's row
  float* As = Cw + kWarps * D;     // [D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int D3 = 3 * D;
  const float* yb = y + b * G * D3;

  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    T[j * Dp + d] = yb[(size_t)j * D3 + D + d];
  }
  for (int d = tid; d < D; d += kThreads) As[d] = a[d];
  __syncthreads();

  // Eq. (8) scores: warp per centre row i, lane per neighbour j
  float* c = Cw + warp * D;
  for (int i = warp; i < G; i += kWarps) {
    for (int d = lane; d < D; d += 32) c[d] = yb[(size_t)i * D3 + 2 * D + d] + k3[b * D + d];
    __syncwarp();
    for (int j = lane; j < G; j += 32) {
      const float* kj = T + j * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(As[d], fmaxf(kj[d] + c[d], 0.f), s);
      S[i * G + j] = s;
    }
    __syncwarp();
  }
  __syncthreads();

  // leaky ReLU, mask, softmax over j
  const unsigned char* adjb = adj + b * G * G;
  for (int i = warp; i < G; i += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < G; j += 32) {
      const float s = S[i * G + j];
      float e = s > 0.f ? s : slope * s;
      e = adjb[i * G + j] ? e : kMaskFill;
      S[i * G + j] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < G; j += 32) {
      const float p = expf(S[i * G + j] - m);
      S[i * G + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < G; j += 32) S[i * G + j] = S[i * G + j] / sum;
  }
  __syncthreads();

  // h replaces k1, then out = relu(alpha h) + x
  for (int e = tid; e < G * D; e += kThreads) {
    const int j = e / D, d = e - j * D;
    T[j * Dp + d] = yb[(size_t)j * D3 + d];
  }
  __syncthreads();
  const float* xb = x + b * G * D;
  float* ob = out + b * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const float* al = S + i * G;
    float o = 0.f;
    for (int j = 0; j < G; ++j) o = fmaf(al[j], T[j * Dp + d], o);
    ob[e] = fmaxf(o, 0.f) + xb[e];
  }
}

}  // namespace

// Reads the card's opt-in shared-memory limit and grants it to the
// per-graph kernel. Called once, when the library is loaded.
extern "C" int gat_layer_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gat_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_smem);
  }
  return static_cast<int>(e);
}

// Step 1: y = x [W|W1|W2] + [bW|0|0] and k3 = q W3 + b3, weights [out, in].
extern "C" int gat_layer_project_f32(const void* x, const void* q, const void* w,
                                     const void* bW, const void* w1, const void* w2,
                                     const void* w3, const void* b3, void* y, void* k3,
                                     int B, int G, int D, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * G, N = 3 * D;
  if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowSet wcat{{static_cast<const float*>(w), static_cast<const float*>(w1),
                     static_cast<const float*>(w2)}, D};
  sgemm_bias_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), kThreads, 0, st>>>(
      static_cast<const float*>(x), wcat, static_cast<const float*>(bW), D,
      static_cast<float*>(y), M, N, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* w3f = static_cast<const float*>(w3);
  sgemm_bias_kernel<<<dim3((D + BN - 1) / BN, (B + BM - 1) / BM), kThreads, 0, st>>>(
      static_cast<const float*>(q), RowSet{{w3f, w3f, w3f}, D},
      static_cast<const float*>(b3), D, static_cast<float*>(k3), B, D, D);
  return static_cast<int>(cudaGetLastError());
}

// Step 2: scores, mask, softmax over j, out = relu(alpha h) + x.
extern "C" int gat_layer_attend_f32(const void* x, const void* adj, const void* y,
                                    const void* k3, const void* a, void* out, int B, int G,
                                    int D, float slope, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * layer_smem_floats(G, D);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  gat_layer_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(adj),
      static_cast<const float*>(y), static_cast<const float*>(k3),
      static_cast<const float*>(a), static_cast<float*>(out), G, D, slope);
  return static_cast<int>(cudaGetLastError());
}
