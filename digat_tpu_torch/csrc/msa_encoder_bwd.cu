// Fused MSA news encoder, recompute backward, fp32, for sm_90a (kernel A').
//
// Replaces the TPU kernel digat_tpu/ops/pallas/msa_encoder.py
// (_encoder_bwd -> _call(is_bwd) -> _bwd_kernel, and _bwd_kernel_v2, which
// computes the same gradients). Given the embedded titles x [N, L, Din], the
// title mask, the weights and dp = dLoss/dpooled [N, D], it recomputes the
// forward of kernel A and returns dx [N, L, Din] and the gradients of W_Q,
// b_Q, W_K, W_V, b_V, affine1 (W1, b1) and affine2 (v). The word-dropout mask
// is drawn again from the same Philox bits as the forward (philox.cuh) and
// applied to x on the way in and to dx on the way out; it never reaches
// device memory.
//
// What bounds it on an H100: arithmetic. At N titles the projections cost
// 2*N*L*Din*3D FLOP three times (recompute, dx, dW) and the pool product
// 2*N*L*D*A three times (recompute, dh, dW1): at N = 10,240, L 32, Din 300,
// D 400, A 256 that is 0.91 TFLOP, against about 0.8 GB that must move.
//
// Design. The TPU kernel keeps a tile of titles in 16 MB of VMEM and sums
// the weight gradients in output blocks revisited across its sequential
// grid. A block here has at most 227 KB of shared memory and blocks run in
// no order, so the backward is a chain of launches on the caller's stream,
// with scratch in device memory that the wrapper allocates:
//   1. xd = dropout(x) (Philox, per title), written to scratch;
//   2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv], the tiled fp32 GEMM of
//      common.cuh ([N*L, 3D]);
//   3. one block per title (msa_bwd_title_kernel) keeps its q|k|v rows
//      (154 KB) and the pool gradient (32 KB) in shared memory: attention
//      forward, h = relu(P v) (written out), the tanh-MLP pool forward and
//      backward (dpre = dLoss/d(h W1^T + b1) written out), then per head
//      dh = alpha dp + dpre W1 masked by h > 0, and the attention backward,
//      whose dq|dk|dv overwrite that title's qkv rows;
//   4. dx = dqkv [Wq;Wk;Wv] (GEMM), then the dropout mask on dx in place;
//   5. dW = dqkv^T xd and dW1 = dpre^T h, GEMMs split over the N*L rows into
//      fixed slices, each slice to its own partial, then summed in slice
//      order; the bias and v gradients are column sums reduced the same way.
// Every reduction is a fixed-order sum of partials (no atomics), so the
// result is the same bits on every run. Plain fp32 FMA on the CUDA cores;
// wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kL = 32;  // title length: one warp lane per position
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskFill = -1e9f;
constexpr int kRowsPerSplit = 8192;  // rows of one slice of a split reduction

using digat::Bias;
using digat::Mat;
using digat::warp_max;
using digat::warp_sum;

// ---------------------------------------------------------------------------
// Dropout on [n, per_title] rows, in place allowed (Philox as in kernel A)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dropout_apply_kernel(const float* in, float* out, long long n, int per_title, uint32_t thresh,
                     float drop_scale, uint32_t seed, uint32_t site) {
  const int groups = per_title / 4;
  const long long total = n * groups;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long r = t / groups;
    const digat::Philox4 d =
        digat::dropout_draws(uint32_t(r), uint32_t(t - r * groups), seed, site);
    float4 v = in4[t];
    v.x = d.x >= thresh ? v.x * drop_scale : 0.f;
    v.y = d.y >= thresh ? v.y * drop_scale : 0.f;
    v.z = d.z >= thresh ? v.z * drop_scale : 0.f;
    v.w = d.w >= thresh ? v.w * drop_scale : 0.f;
    out4[t] = v;
  }
}

// out[i] = sum over s (in order) of part[s * n + i]
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long n, int splits) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// part[z][c] = sum of A[r][c] over the z-th slice of rows
__global__ void colsum_kernel(const float* __restrict__ A, int M, int N, int rows_per_split,
                              float* __restrict__ part) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * rows_per_split, r1 = min(M, r0 + rows_per_split);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += A[(size_t)r * N + c];
  part[(size_t)blockIdx.y * N + c] = s;
}

// ---------------------------------------------------------------------------
// Per-title recompute and backward
// ---------------------------------------------------------------------------
__host__ __device__ inline int align4(int f) { return (f + 3) & ~3; }

// floats of the union region: the attention forward's scratch, or the
// per-head backward's (W1 head slice, dO, P, dP/dS, k or v transposed)
__host__ __device__ inline int title_scratch_floats(int dk, int A) {
  const int fwd = kL * kL + dk * kL;
  const int bwd = A * dk + kL * dk + 2 * kL * kL + dk * kL;
  return align4(fwd > bwd ? fwd : bwd);
}

__host__ __device__ inline size_t title_smem_bytes(int D, int dk, int A) {
  const int misc = 2 * kL + kWarps * kL;  // alpha, dlg, per-warp logit partials
  return sizeof(float) *
         (size_t(kL) * 3 * D + align4(kL * A) + align4(misc) + title_scratch_floats(dk, A));
}

int g_max_smem = 0;  // opt-in shared memory per block, set by msa_encoder_bwd_init

__global__ void __launch_bounds__(kThreads)
msa_bwd_title_kernel(float* __restrict__ qkv_g,              // [N*L, 3D]: q|k|v in, dq|dk|dv out
                     const unsigned char* __restrict__ mask,  // [N, L]
                     const float* __restrict__ w1,            // [A, D]
                     const float* __restrict__ b1,            // [A]
                     const float* __restrict__ v,             // [A]
                     const float* __restrict__ dp,            // [N, D]
                     float* __restrict__ h_g,                 // [N*L, D] out
                     float* __restrict__ dpre_g,              // [N*L, A] out
                     float* __restrict__ dv_part,             // [N, A] out
                     int heads, int dk, int A, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = heads * dk, N3 = 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n = blockIdx.x;
  float* qkv = smem;                    // [kL][3D]; q columns hold h in phases 2-3
  float* dpre = qkv + kL * N3;          // [kL][A]
  float* alpha = dpre + align4(kL * A);  // [kL]
  float* dlg = alpha + kL;              // [kL]
  float* part = dlg + kL;               // [kWarps][kL]
  float* scr = alpha + align4(2 * kL + kWarps * kL);
  float* qkv_rows = qkv_g + n * kL * N3;

  // ---- 1. this title's q|k|v ----
  for (int e = tid; e < kL * N3 / 4; e += kThreads)
    reinterpret_cast<float4*>(qkv)[e] = reinterpret_cast<const float4*>(qkv_rows)[e];
  __syncthreads();

  // ---- 2. attention forward per head; relu(P v) overwrites q (as kernel A) ----
  {
    float* S = scr;
    float* kT = scr + kL * kL;
    for (int hd = 0; hd < heads; ++hd) {
      const int qo = hd * dk, ko = D + hd * dk, vo = 2 * D + hd * dk;
      for (int e = tid; e < kL * dk; e += kThreads) {
        const int j = e / dk, c = e - j * dk;
        kT[c * kL + j] = qkv[j * N3 + ko + c];
      }
      __syncthreads();
      for (int e = tid; e < kL * kL; e += kThreads) {
        const int i = e >> 5, j = e & 31;
        const float* qi = qkv + i * N3 + qo;
        float s = 0.f;
        for (int c = 0; c < dk; ++c) s = fmaf(qi[c], kT[c * kL + j], s);
        S[e] = s * scale;
      }
      __syncthreads();
      for (int i = warp; i < kL; i += kWarps) {
        const float s = S[i * kL + lane];
        const float m = warp_max(s);
        const float p = expf(s - m);
        S[i * kL + lane] = p / warp_sum(p);
      }
      __syncthreads();
      for (int e = tid; e < kL * dk; e += kThreads) {
        const int i = e / dk, c = e - i * dk;
        float o = 0.f;
#pragma unroll 8
        for (int j = 0; j < kL; ++j) o = fmaf(S[i * kL + j], qkv[j * N3 + vo + c], o);
        qkv[i * N3 + qo + c] = fmaxf(o, 0.f);
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < kL * D; e += kThreads) {
    const int l = e / D, d = e - l * D;
    h_g[(n * kL + l) * D + d] = qkv[l * N3 + d];
  }

  // ---- 3. pool forward and backward; thread `tid` owns pool column tid ----
  const bool has_col = tid < A;
  float u[kL];
  float lg[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) u[l] = lg[l] = 0.f;
  if (has_col) {
    const float* wrow = w1 + (size_t)tid * D;
    for (int k = 0; k < D; k += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + k));
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4 hv = *reinterpret_cast<const float4*>(qkv + l * N3 + k);
        float a = u[l];
        a = fmaf(hv.x, w.x, a);
        a = fmaf(hv.y, w.y, a);
        a = fmaf(hv.z, w.z, a);
        a = fmaf(hv.w, w.w, a);
        u[l] = a;
      }
    }
    const float bb = b1[tid], vv = v[tid];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      u[l] = tanhf(u[l] + bb);
      lg[l] = u[l] * vv;
    }
  }
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const float t = warp_sum(lg[l]);
    if (lane == 0) part[warp * kL + l] = t;
  }
  __syncthreads();
  if (warp == 0) {  // masked softmax over positions (-1e9 fill; all-pad -> uniform)
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * kL + lane];
    const float logit = mask[n * kL + lane] ? s : kMaskFill;
    const float m = warp_max(logit);
    const float p = expf(logit - m);
    alpha[lane] = p / warp_sum(p);
  }
  // dalpha[l] = dp . h[l] (held in dlg until the softmax backward)
  for (int l = warp; l < kL; l += kWarps) {
    float t = 0.f;
    for (int d = lane; d < D; d += 32) t = fmaf(dp[n * D + d], qkv[l * N3 + d], t);
    t = warp_sum(t);
    if (lane == 0) dlg[l] = t;
  }
  __syncthreads();
  if (warp == 0) {  // softmax backward; a masked logit passes no gradient
    const float a = alpha[lane], da = dlg[lane];
    const float s = warp_sum(a * da);
    dlg[lane] = mask[n * kL + lane] ? (da - s) * a : 0.f;
  }
  __syncthreads();
  if (has_col) {
    const float vv = v[tid];
    float dvacc = 0.f;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const float g = dlg[l];
      dvacc = fmaf(u[l], g, dvacc);
      const float dz = g * vv * (1.f - u[l] * u[l]);
      dpre[l * A + tid] = dz;
      dpre_g[(n * kL + l) * A + tid] = dz;
    }
    dv_part[n * A + tid] = dvacc;
  }

  // ---- 4. q back in place of h (h is read from h_g from here on) ----
  __syncthreads();
  for (int e = tid; e < kL * D; e += kThreads) {
    const int l = e / D, d = e - l * D;
    qkv[l * N3 + d] = qkv_rows[(size_t)l * N3 + d];
  }
  __syncthreads();

  // ---- 5. per head: dO = (alpha dp + dpre W1) * (h > 0), attention backward ----
  float* Ws = scr;                 // [A][dk]: W1 columns of this head
  float* dO = Ws + A * dk;         // [kL][dk]
  float* P = dO + kL * dk;         // [kL][kL]
  float* PS = P + kL * kL;         // [kL][kL]: dP, then dS
  float* kvT = PS + kL * kL;       // [dk][kL]: k, then v, transposed
  for (int hd = 0; hd < heads; ++hd) {
    const int qo = hd * dk, ko = D + hd * dk, vo = 2 * D + hd * dk;
    for (int e = tid; e < A * dk; e += kThreads) {
      const int a = e / dk, c = e - a * dk;
      Ws[e] = w1[(size_t)a * D + qo + c];
    }
    for (int e = tid; e < kL * dk; e += kThreads) {
      const int j = e / dk, c = e - j * dk;
      kvT[c * kL + j] = qkv[j * N3 + ko + c];
    }
    __syncthreads();
    for (int e = tid; e < kL * kL; e += kThreads) {
      const int i = e >> 5, j = e & 31;
      const float* qi = qkv + i * N3 + qo;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(qi[c], kvT[c * kL + j], s);
      P[e] = s * scale;
    }
    for (int e = tid; e < kL * dk; e += kThreads) {
      const int i = e / dk, c = e - i * dk, col = qo + c;
      float acc = alpha[i] * dp[n * D + col];
      const float* zi = dpre + i * A;
      for (int a = 0; a < A; ++a) acc = fmaf(zi[a], Ws[a * dk + c], acc);
      dO[e] = h_g[(n * kL + i) * D + col] > 0.f ? acc : 0.f;
    }
    __syncthreads();
    for (int i = warp; i < kL; i += kWarps) {
      const float s = P[i * kL + lane];
      const float m = warp_max(s);
      const float p = expf(s - m);
      P[i * kL + lane] = p / warp_sum(p);
    }
    for (int e = tid; e < kL * dk; e += kThreads) {
      const int j = e / dk, c = e - j * dk;
      kvT[c * kL + j] = qkv[j * N3 + vo + c];
    }
    __syncthreads();
    for (int e = tid; e < kL * kL; e += kThreads) {  // dP = dO v^T
      const int i = e >> 5, j = e & 31;
      const float* oi = dO + i * dk;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(oi[c], kvT[c * kL + j], s);
      PS[e] = s;
    }
    __syncthreads();
    for (int i = warp; i < kL; i += kWarps) {  // dS = P (dP - rowsum(P dP)) scale
      const float p = P[i * kL + lane], d = PS[i * kL + lane];
      const float r = warp_sum(p * d);
      PS[i * kL + lane] = p * (d - r) * scale;
    }
    __syncthreads();
    for (int e = tid; e < kL * dk; e += kThreads) {
      const int r = e / dk, c = e - r * dk;
      float dq = 0.f, dkk = 0.f, dvv = 0.f;
#pragma unroll 8
      for (int j = 0; j < kL; ++j) {
        dq = fmaf(PS[r * kL + j], qkv[j * N3 + ko + c], dq);
        dkk = fmaf(PS[j * kL + r], qkv[j * N3 + qo + c], dkk);
        dvv = fmaf(P[j * kL + r], dO[j * dk + c], dvv);
      }
      float* row = qkv_rows + (size_t)r * N3;
      row[qo + c] = dq;
      row[ko + c] = dkk;
      row[vo + c] = dvv;
    }
    __syncthreads();
  }
}

inline int grid_1d(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return int(b < 132 * 32 ? (b > 0 ? b : 1) : 132 * 32);
}

inline int splits_of(long long rows) { return int((rows + kRowsPerSplit - 1) / kRowsPerSplit); }

// floats of each scratch array, in the order they sit in the scratch buffer
struct Scratch {
  size_t xd, qkv, h, dpre, dvp, part, cpart;
  size_t total() const { return xd + qkv + h + dpre + dvp + part + cpart; }
};

Scratch scratch_of(int N, int Din, int D, int A) {
  const long long M = (long long)N * kL;
  const long long S = splits_of(M), Sn = splits_of(N);
  Scratch s;
  s.xd = size_t(M) * Din;
  s.qkv = size_t(M) * 3 * D;
  s.h = size_t(M) * D;
  s.dpre = size_t(M) * A;
  s.dvp = size_t(N) * A;
  const long long p1 = S * 3LL * D * Din, p2 = S * (long long)A * D;
  s.part = size_t(p1 > p2 ? p1 : p2);
  const long long c1 = S * 3LL * D, c2 = S * (long long)A, c3 = Sn * (long long)A;
  s.cpart = size_t(c1 > c2 ? (c1 > c3 ? c1 : c3) : (c2 > c3 ? c2 : c3));
  return s;
}

// out[0:N] = column sums of A [M, N] (fixed slices, then summed in order)
cudaError_t colsum(cudaStream_t st, const float* A, int M, int N, float* part, float* out) {
  const int S = splits_of(M);
  colsum_kernel<<<dim3((N + kThreads - 1) / kThreads, S), kThreads, 0, st>>>(
      A, M, N, kRowsPerSplit, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_splits_kernel<<<grid_1d(N), kThreads, 0, st>>>(part, out, N, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int msa_encoder_bwd_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(msa_bwd_title_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_smem);
  }
  return static_cast<int>(e);
}

// Floats of scratch that msa_encoder_bwd_f32 needs (0 if the shapes are not
// taken).
extern "C" long long msa_encoder_bwd_scratch_floats(int N, int L, int Din, int heads, int dk,
                                                    int A) {
  if (N <= 0 || L != kL || Din <= 0 || heads <= 0 || dk <= 0 || A <= 0) return 0;
  return (long long)scratch_of(N, Din, heads * dk, A).total();
}

// dx [N, L, Din]; dwqkv [3D, Din] (dWq, dWk, dWv stacked, nn.Linear layout);
// dbqkv [3D]; dw1 [A, D]; db1 [A]; dv [A]. Weights in nn.Linear layout.
extern "C" int msa_encoder_bwd_f32(const void* x, const void* mask, const void* wq,
                                   const void* bq, const void* wk, const void* wv,
                                   const void* bv, const void* w1, const void* b1,
                                   const void* v, const void* dp, void* dx, void* dwqkv,
                                   void* dbqkv, void* dw1, void* db1, void* dv, void* scratch,
                                   int N, int L, int Din, int heads, int dk, int A, float scale,
                                   unsigned thresh, float drop_scale, unsigned seed,
                                   unsigned site, void* stream) {
  const int D = heads * dk;
  if (N <= 0 || L != kL || Din <= 0 || Din % 4 != 0 || D % 4 != 0 || A <= 0 || A > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (title_smem_bytes(D, dk, A) > size_t(g_max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch sz = scratch_of(N, Din, D, A);
  float* xd = static_cast<float*>(scratch);
  float* qkv = xd + sz.xd;
  float* h = qkv + sz.qkv;
  float* dpre = h + sz.h;
  float* dvp = dpre + sz.dpre;
  float* part = dvp + sz.dvp;
  float* cpart = part + sz.part;
  const int M = N * kL;
  const int S = splits_of(M);
  const float* fx = static_cast<const float*>(x);
  const float* fwq = static_cast<const float*>(wq);
  const float* fwk = static_cast<const float*>(wk);
  const float* fwv = static_cast<const float*>(wv);
  const float* fw1 = static_cast<const float*>(w1);
  const Mat wstack{{fwq, fwk, fwv}, D, Din};  // [3D, Din]
  const Bias none{{nullptr, nullptr, nullptr}, 0};
  cudaError_t e;

  // 1. xd = dropout(x); without dropout xd is x itself
  const float* xin = fx;
  if (thresh) {
    dropout_apply_kernel<<<grid_1d((long long)N * kL * Din / 4), kThreads, 0, st>>>(
        fx, xd, N, kL * Din, thresh, drop_scale, seed, site);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    xin = xd;
  }
  // 2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv]
  const Bias bqkv{{static_cast<const float*>(bq), nullptr, static_cast<const float*>(bv)}, D};
  e = digat::gemm<false, true>(st, digat::mat1(xin, Din), wstack, bqkv, qkv, M, 3 * D, Din,
                              Din);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 3. per title
  msa_bwd_title_kernel<<<N, kThreads, title_smem_bytes(D, dk, A), st>>>(
      qkv, static_cast<const unsigned char*>(mask), fw1, static_cast<const float*>(b1),
      static_cast<const float*>(v), static_cast<const float*>(dp), h, dpre, dvp, heads, dk, A,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  // 4. dx = dqkv [Wq;Wk;Wv], then the dropout mask
  float* fdx = static_cast<float*>(dx);
  e = digat::gemm<false, false>(st, digat::mat1(qkv, 3 * D), wstack, none, fdx, M, Din,
                               3 * D, 3 * D);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (thresh) {
    dropout_apply_kernel<<<grid_1d((long long)N * kL * Din / 4), kThreads, 0, st>>>(
        fdx, fdx, N, kL * Din, thresh, drop_scale, seed, site);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  // 5. weight gradients: split over rows, partials summed in order
  e = digat::gemm<true, false>(st, digat::mat1(qkv, 3 * D), digat::mat1(xin, Din), none, part,
                              3 * D, Din, M, kRowsPerSplit);
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_splits_kernel<<<grid_1d(3LL * D * Din), kThreads, 0, st>>>(
      part, static_cast<float*>(dwqkv), 3LL * D * Din, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  e = digat::gemm<true, false>(st, digat::mat1(dpre, A), digat::mat1(h, D), none, part, A, D,
                              M, kRowsPerSplit);
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_splits_kernel<<<grid_1d((long long)A * D), kThreads, 0, st>>>(
      part, static_cast<float*>(dw1), (long long)A * D, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = colsum(st, qkv, M, 3 * D, cpart, static_cast<float*>(dbqkv))) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = colsum(st, dpre, M, A, cpart, static_cast<float*>(db1))) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(colsum(st, dvp, N, A, cpart, static_cast<float*>(dv)));
}
