// Eq. (8) interactive graph-attention scores, forward and backward, fp32,
// for sm_90a (kernel C).
//
// Replaces the TPU kernels digat_tpu/ops/pallas/gat_scores.py
// (interactive_gat_scores_pallas -> _scores_kernel, and its custom-VJP
// backward _bwd_kernel; C', the fused-y entry point, runs these on y's
// column blocks). For each graph b:
//
//     s[i, j]  = a . relu(k1[j] + (k2[i] + k3))              (forward)
//     m        = (k1[j] + (k2[i] + k3) > 0)
//     gk1[j]   = a * sum_i g[i, j] m[i, j]                   (backward)
//     gk2[i]   = a * sum_j g[i, j] m[i, j]
//     gk3      = a * sum_i sum_j g[i, j] m[i, j]
//     ga       = sum_b sum_ij g[i, j] relu(k1[j] + (k2[i] + k3))
//
// What bounds it on an H100: arithmetic on the CUDA cores. Each (b, i, j, d)
// costs 3 issued operations forward (add, max, multiply-add) and 6 backward
// (add, compare, select, three sums), against 4 * B * G * D bytes of k1 and
// k2: at B 320, G 68, D 400 that is 592 M elements, about 0.06 / 0.12 ms at
// the card's fp32 issue rate (Hopper has no packed fp32 multiply-add).
// Neither pass ever forms [G, G, D]: the relu mask is recomputed in the
// backward, not stored.
//
// Forward: register tiles over (i, j), features in slices. A block takes a
// tile of rows i and columns j of one graph (gat_scores.py::fwd_plan: the
// whole graph up to G 128); each thread an R x R tile of scores (R 4, or 2
// for small graphs) kept in registers. k2 + k3 of the block's rows, k1 of
// its columns and a are staged in shared memory one slice of kDS features at
// a time, transposed ([d][i], [d][j]), so that per feature a thread reads
// its R values of each side as one vector load and a as a broadcast, for
// R * R (add, max, multiply-add): one shared load to about five operations,
// where the one-block-per-graph kernel this replaces read three for three.
// The footprint is a few KB whatever G is (that kernel held all of k1 and
// k2 + k3, 218 KB at G 68, and took G up to about 72), so several blocks
// run per SM. Each score sums over d in order from 0.
//
// Backward in one sweep (gat_scores.py::bwd_plan). A thread per feature d of
// graph b, blocks per (graph, slice of D). The thread holds k1[j, d] and
// gk1's sums for a tile of JT columns j in registers (JT a template
// parameter up to 40; G 68 in two tiles of 36) and walks the rows i once a
// tile: c = k2[i, d] + k3[d] (coalesced over d), g[i, tile] as broadcast
// float4 from shared memory, and for each (i, j) t, its mask and w = m g
// once, adding w to gk2's row sum, w to gk1[j] and w t to ga. Where G takes
// several tiles, a row's sums from each tile combine in tile order through a
// shared [G][DT] buffer of the thread's own column; gk2 and gk3 are written
// on the last tile. ga's per-graph partials are summed over the graphs in
// graph order by sum_graphs_kernel. No atomics: the same bits on every run.
//
// k1 and k2 may be column blocks of a wider row-major array (the fused
// projection y = x [W|W1|W2]): rows are read with their own row stride.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDS = 32;                // features of one forward slice
constexpr int kMaxFwdThreads = 512;    // a forward block
constexpr int kMaxBwdThreads = 256;    // a backward block: one slice of D
constexpr int kMaxJT = 40;             // backward columns j a thread holds

int g_max_smem = 0;  // opt-in shared memory per block, set by gat_scores_init

// Row stride of a transposed forward slice of `w` rows (w a multiple of 4):
// an odd number of float4s, so that the staging stores of 32 features of
// one row fall on 8 bank quads.
__host__ __device__ inline int slice_stride(int w) { return (w / 4) % 2 ? w : w + 4; }

__host__ __device__ inline size_t fwd_smem_floats(int BI, int BJ) {
  return size_t(kDS) * (slice_stride(BI) + slice_stride(BJ)) + kDS;
}

__host__ __device__ inline size_t bwd_smem_floats(int G, int JT, int DT, int ntiles) {
  return size_t(G) * JT + (ntiles > 1 ? size_t(G) * DT : 0);
}

template <int R>
__device__ __forceinline__ void load_r(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// grid (row tiles, column tiles, B); block round32(TIb * TJb) threads
template <int R>
__global__ void __launch_bounds__(kMaxFwdThreads)
gat_scores_fwd_kernel(const float* __restrict__ k1, int ld1, const float* __restrict__ k2,
                      int ld2, const float* __restrict__ k3, const float* __restrict__ a,
                      float* __restrict__ out, int G, int D, int TIb, int TJb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int BI = TIb * R, BJ = TJb * R;
  const int SI = slice_stride(BI), SJ = slice_stride(BJ);
  float* K2T = smem;            // [kDS][SI]: k2 + k3 of the block's rows
  float* K1T = K2T + kDS * SI;  // [kDS][SJ]: k1 of its columns
  float* As = K1T + kDS * SJ;   // [kDS]
  const size_t b = blockIdx.z;
  const int i0 = blockIdx.x * BI, j0 = blockIdx.y * BJ;
  const int t = threadIdx.x, ti = t / TJb, tj = t - ti * TJb;
  const bool active = ti < TIb;
  const float* k1b = k1 + b * G * ld1;
  const float* k2b = k2 + b * G * ld2;
  const float* k3b = k3 + b * D;

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < R; ++q) acc[r][q] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kDS) {
    const int nd = min(kDS, D - d0);
    // stage the slice, features fastest (coalesced rows); zero past G
    for (int e = t; e < (BI + BJ) * kDS; e += blockDim.x) {
      const int r = e / kDS, dd = e - r * kDS, d = d0 + dd;
      if (r < BI) {
        const int i = i0 + r;
        K2T[dd * SI + r] = i < G && dd < nd ? k2b[(size_t)i * ld2 + d] + k3b[d] : 0.f;
      } else {
        const int j = j0 + r - BI;
        K1T[dd * SJ + r - BI] = j < G && dd < nd ? k1b[(size_t)j * ld1 + d] : 0.f;
      }
    }
    if (t < kDS) As[t] = t < nd ? a[d0 + t] : 0.f;
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int dd = 0; dd < nd; ++dd) {
        const float ad = As[dd];
        float c[R], k[R];
        load_r<R>(K2T + dd * SI + ti * R, c);
        load_r<R>(K1T + dd * SJ + tj * R, k);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) acc[r][q] = fmaf(ad, fmaxf(k[q] + c[r], 0.f), acc[r][q]);
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* ob = out + b * G * G;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + ti * R + r;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = j0 + tj * R + q;
      if (i < G && j < G) ob[(size_t)i * G + j] = acc[r][q];
    }
  }
}

// grid (slices of D, B); block DT threads, thread = feature d
template <int JT>
__global__ void __launch_bounds__(kMaxBwdThreads)
gat_scores_bwd_kernel(const float* __restrict__ k1, int ld1, const float* __restrict__ k2,
                      int ld2, const float* __restrict__ k3, const float* __restrict__ a,
                      const float* __restrict__ g, float* __restrict__ gk1,
                      float* __restrict__ gk2, float* __restrict__ gk3,
                      float* __restrict__ ga_part, int G, int D, int ntiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DT = blockDim.x;
  float* gs = smem;            // [G][JT]: the tile's columns of g, zero past G
  float* rsb = gs + G * JT;    // [G][DT]: each row's sum over the earlier tiles
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x, d = blockIdx.x * DT + tid;
  const bool active = d < D;
  const float ad = active ? a[d] : 0.f, k3d = active ? k3[b * D + d] : 0.f;
  const float* k1b = k1 + b * G * ld1;
  const float* k2b = k2 + b * G * ld2;
  const float* gb = g + b * G * G;
  float ga = 0.f, sum3 = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j0 = tile * JT;
    const bool first = tile == 0, last = tile == ntiles - 1;
    __syncthreads();  // the previous tile's g read for the last time
    for (int e = tid; e < G * JT; e += DT) {
      const int i = e / JT, jj = e - i * JT;
      gs[e] = j0 + jj < G ? gb[(size_t)i * G + j0 + jj] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    float kj[JT], acc[JT];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      kj[jj] = j0 + jj < G ? k1b[(size_t)(j0 + jj) * ld1 + d] : 0.f;
      acc[jj] = 0.f;
    }
    float cn = k2b[d] + k3d;
    for (int i = 0; i < G; ++i) {
      const float c = cn;
      if (i + 1 < G) cn = k2b[(size_t)(i + 1) * ld2 + d] + k3d;
      const float4* g4 = reinterpret_cast<const float4*>(gs + i * JT);
      float rs = 0.f, gai = 0.f;
#pragma unroll
      for (int q = 0; q < JT / 4; ++q) {
        const float4 gv = g4[q];
        const float gq[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jj = 4 * q + u;
          const float t = kj[jj] + c;
          const float w = t > 0.f ? gq[u] : 0.f;
          rs += w;
          acc[jj] += w;
          gai = fmaf(w, t, gai);
        }
      }
      ga += gai;
      float* prev = rsb + i * DT + tid;
      const float total = first ? rs : *prev + rs;
      if (last) {
        gk2[(b * G + i) * D + d] = ad * total;
        sum3 += total;
      } else {
        *prev = total;
      }
    }
#pragma unroll
    for (int jj = 0; jj < JT; ++jj)
      if (j0 + jj < G) gk1[(b * G + j0 + jj) * D + d] = ad * acc[jj];
  }
  if (active) {
    gk3[b * D + d] = ad * sum3;
    ga_part[b * D + d] = ga;
  }
}

// ga[d] = sum over graphs b, in order, of ga_part[b][d]
__global__ void sum_graphs_kernel(const float* __restrict__ part, float* __restrict__ out, int B,
                                  int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * D + d];
  out[d] = s;
}

template <int JT>
cudaError_t launch_bwd(dim3 grid, int DT, size_t smem, cudaStream_t st, const float* k1, int ld1,
                       const float* k2, int ld2, const float* k3, const float* a, const float* g,
                       float* gk1, float* gk2, float* gk3, float* ga_part, int G, int D,
                       int ntiles) {
  gat_scores_bwd_kernel<JT><<<grid, DT, smem, st>>>(k1, ld1, k2, ld2, k3, a, g, gk1, gk2, gk3,
                                                    ga_part, G, D, ntiles);
  return cudaGetLastError();
}

// A tile width of the backward: the kernel instantiated at that width.
template <int JT>
cudaError_t set_bwd_smem() {
  return cudaFuncSetAttribute(gat_scores_bwd_kernel<JT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
}

inline int round32(int n) { return (n + 31) / 32 * 32; }

}  // namespace

extern "C" int gat_scores_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaError_t set[] = {set_bwd_smem<4>(),  set_bwd_smem<8>(),  set_bwd_smem<12>(),
                             set_bwd_smem<16>(), set_bwd_smem<20>(), set_bwd_smem<24>(),
                             set_bwd_smem<28>(), set_bwd_smem<32>(), set_bwd_smem<36>(),
                             set_bwd_smem<40>()};
  for (const cudaError_t f : set) {
    if (f != cudaSuccess) return static_cast<int>(f);
  }
  return 0;
}

// s [B, G, G] from k1, k2 (rows of ld1 / ld2 floats, graph b's rows at
// b * G), k3 [B, D], a [D]. The plan (gat_scores.py::fwd_plan): R x R
// scores a thread, TIb x TJb threads' tiles a block.
extern "C" int gat_scores_fwd_f32(const void* k1, int ld1, const void* k2, int ld2,
                                  const void* k3, const void* a, void* out, int B, int G, int D,
                                  int R, int TIb, int TJb, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || ld1 < D || ld2 < D || (R != 2 && R != 4) || TIb <= 0 ||
      TJb <= 0 || round32(TIb * TJb) > kMaxFwdThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int TI = (G + R - 1) / R;
  const dim3 grid((TI + TIb - 1) / TIb, (TI + TJb - 1) / TJb, B);
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * fwd_smem_floats(TIb * R, TJb * R);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *p1 = static_cast<const float*>(k1), *p2 = static_cast<const float*>(k2),
              *p3 = static_cast<const float*>(k3), *pa = static_cast<const float*>(a);
  float* po = static_cast<float*>(out);
  if (R == 4) {
    gat_scores_fwd_kernel<4><<<grid, round32(TIb * TJb), smem, st>>>(p1, ld1, p2, ld2, p3, pa,
                                                                      po, G, D, TIb, TJb);
  } else {
    gat_scores_fwd_kernel<2><<<grid, round32(TIb * TJb), smem, st>>>(p1, ld1, p2, ld2, p3, pa,
                                                                      po, G, D, TIb, TJb);
  }
  return static_cast<int>(cudaGetLastError());
}

// gk1, gk2 [B, G, D], gk3 [B, D], ga [D] from the score gradient g [B, G, G];
// ga_part [B, D] is scratch. The plan (gat_scores.py::bwd_plan): ntiles
// tiles of JT columns, blocks of DT features.
extern "C" int gat_scores_bwd_f32(const void* k1, int ld1, const void* k2, int ld2,
                                  const void* k3, const void* a, const void* g, void* gk1,
                                  void* gk2, void* gk3, void* ga, void* ga_part, int B, int G,
                                  int D, int ntiles, int JT, int DT, void* stream) {
  if (B <= 0 || G <= 0 || D <= 0 || ld1 < D || ld2 < D || ntiles <= 0 || JT <= 0 ||
      JT % 4 != 0 || JT > kMaxJT || ntiles * JT < G || DT <= 0 || DT % 32 != 0 ||
      DT > kMaxBwdThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * bwd_smem_floats(G, JT, DT, ntiles);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + DT - 1) / DT, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *p1 = static_cast<const float*>(k1), *p2 = static_cast<const float*>(k2),
              *p3 = static_cast<const float*>(k3), *pa = static_cast<const float*>(a),
              *pg = static_cast<const float*>(g);
  float *o1 = static_cast<float*>(gk1), *o2 = static_cast<float*>(gk2),
        *o3 = static_cast<float*>(gk3), *op = static_cast<float*>(ga_part);
  cudaError_t e;
  switch (JT) {
#define DIGAT_BWD(W)                                                                            \
  case W:                                                                                       \
    e = launch_bwd<W>(grid, DT, smem, st, p1, ld1, p2, ld2, p3, pa, pg, o1, o2, o3, op, G, D,  \
                      ntiles);                                                                  \
    break;
    DIGAT_BWD(4) DIGAT_BWD(8) DIGAT_BWD(12) DIGAT_BWD(16) DIGAT_BWD(20)
    DIGAT_BWD(24) DIGAT_BWD(28) DIGAT_BWD(32) DIGAT_BWD(36) DIGAT_BWD(40)
#undef DIGAT_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_graphs_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      op, static_cast<float*>(ga), B, D);
  return static_cast<int>(cudaGetLastError());
}
