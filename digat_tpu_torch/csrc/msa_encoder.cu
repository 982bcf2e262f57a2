// Fused MSA news encoder, eval forward, fp32, for sm_90a.
//
// Replaces the TPU kernel digat_tpu/ops/pallas/msa_encoder.py
// (msa_encoder_pooled -> _call -> _fwd_kernel), forward at dropout rate 0.
// Per title: Q/K/V projections of the embedded words, 16-head UNMASKED
// softmax attention over the L=32 positions (pads attend, as in the
// reference), ReLU, then the masked tanh-MLP attention pool with the -1e9
// fill, giving one [D] vector. Heads stay unpadded (dk 25, D = 400).
//
// What bounds it on an H100: arithmetic. Per title the projections are
// 2*L*Din*3D = 23 MFLOP, the pool product 2*L*D*A = 6.6 MFLOP and the
// attention 4*L*L*D = 1.6 MFLOP, against 38 KB of input: about 800 FLOP
// per byte, far above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s).
//
// Design: one block of 256 threads per title, everything in shared memory.
// The title [32, Din] is loaded once; each thread owns whole output columns
// of the Q|K|V projection and keeps the 32 row sums of a column in
// registers, so a weight element read from L2 feeds 32 FMAs and each
// shared-memory float4 of the title (a broadcast) feeds 4. The weights are
// read in nn.Linear layout ([out, in], one float4 of a column's row per
// step) straight from the three projections, so nothing is repacked per
// call. q|k|v [32, 3D]
// (154 KB) stay in shared memory; the attention of each head overwrites that
// head's q columns with relu(P V), which makes q the pool input h. The pool
// uses the same column-per-thread scheme over W1 (read as [A, D]) and reduces the
// tanh(.)*v terms across the block, never storing [32, A]. The title tile
// region is reused as scratch once the projections are done. Plain fp32 FMA
// on the CUDA cores: wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 32;  // title length: one warp lane per position
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskFill = -1e9f;

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

// floats of the first shared region: the title tile, later the scratch
__host__ __device__ inline int region0_floats(int Din, int dk) {
  int tile = kL * Din;
  int scratch = kL * kL + dk * kL + kWarps * kL + kL;
  int r = tile > scratch ? tile : scratch;
  return (r + 3) & ~3;  // keep the next region 16-byte aligned
}

int g_max_smem = 0;  // opt-in shared memory per block, set by msa_encoder_init

__global__ void __launch_bounds__(kThreads)
msa_encoder_pooled_kernel(const float* __restrict__ x,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ wq,  // [D, Din]
                          const float* __restrict__ bq,  // [D]
                          const float* __restrict__ wk,  // [D, Din] (no bias)
                          const float* __restrict__ wv,  // [D, Din]
                          const float* __restrict__ bv,  // [D]
                          const float* __restrict__ w1,  // [A, D]
                          const float* __restrict__ b1,  // [A]
                          const float* __restrict__ v,   // [A]
                          float* __restrict__ out,       // [N, D]
                          int Din, int heads, int dk, int A, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = heads * dk;
  const int N3 = 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n = blockIdx.x;

  float* xs = smem;                             // [kL][Din]
  float* qkv = smem + region0_floats(Din, dk);  // [kL][3D]
  float* S = smem;                              // [kL][kL]  (after projections)
  float* kT = S + kL * kL;                      // [dk][kL]
  float* part = kT + dk * kL;                   // [kWarps][kL]
  float* alpha = part + kWarps * kL;            // [kL]

  // ---- load the embedded title ----
  {
    const float4* src = reinterpret_cast<const float4*>(x + n * kL * Din);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int e = tid; e < kL * Din / 4; e += kThreads) dst[e] = src[e];
  }
  __syncthreads();

  // ---- Q|K|V projection: thread owns columns c, all 32 rows ----
  for (int c = tid; c < N3; c += kThreads) {
    const int part = c / D, cc = c - part * D;
    const float* wrow = (part == 0 ? wq : part == 1 ? wk : wv) + (size_t)cc * Din;
    float acc[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) acc[l] = 0.f;
    for (int k = 0; k < Din; k += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + k));
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + l * Din + k);
        float a = acc[l];
        a = fmaf(xv.x, w.x, a);
        a = fmaf(xv.y, w.y, a);
        a = fmaf(xv.z, w.z, a);
        a = fmaf(xv.w, w.w, a);
        acc[l] = a;
      }
    }
    const float bias = part == 0 ? bq[cc] : part == 2 ? bv[cc] : 0.f;
#pragma unroll
    for (int l = 0; l < kL; ++l) qkv[l * N3 + c] = acc[l] + bias;
  }
  __syncthreads();

  // ---- per head: unmasked softmax attention; relu(P V) overwrites q_h ----
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

  // ---- pool logits: sum_a v[a] * tanh(h W1 + b1)[l, a], per row l ----
  float lg[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) lg[l] = 0.f;
  for (int col = tid; col < A; col += kThreads) {
    float acc[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) acc[l] = 0.f;
    const float* wrow = w1 + (size_t)col * D;
    for (int k = 0; k < D; k += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + k));
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4 hv = *reinterpret_cast<const float4*>(qkv + l * N3 + k);
        float a = acc[l];
        a = fmaf(hv.x, w.x, a);
        a = fmaf(hv.y, w.y, a);
        a = fmaf(hv.z, w.z, a);
        a = fmaf(hv.w, w.w, a);
        acc[l] = a;
      }
    }
    const float bb = b1[col], vv = v[col];
#pragma unroll
    for (int l = 0; l < kL; ++l) lg[l] = fmaf(tanhf(acc[l] + bb), vv, lg[l]);
  }
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const float t = warp_sum(lg[l]);
    if (lane == 0) part[warp * kL + l] = t;
  }
  __syncthreads();

  // ---- masked softmax over positions (-1e9 fill; all-pad -> uniform) ----
  if (warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * kL + lane];
    const float logit = mask[n * kL + lane] ? s : kMaskFill;
    const float m = warp_max(logit);
    const float p = expf(logit - m);
    alpha[lane] = p / warp_sum(p);
  }
  __syncthreads();

  // ---- pooled output: sum_l alpha[l] h[l, :] ----
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int l = 0; l < kL; ++l) o = fmaf(alpha[l], qkv[l * N3 + d], o);
    out[n * D + d] = o;
  }
}

}  // namespace

// Reads the card's opt-in shared-memory limit and grants it to the kernel.
// Called once, when the library is loaded.
extern "C" int msa_encoder_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(msa_encoder_pooled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_max_smem);
  }
  return static_cast<int>(e);
}

extern "C" int msa_encoder_pooled_f32(const void* x, const void* mask, const void* wq,
                                      const void* bq, const void* wk, const void* wv,
                                      const void* bv, const void* w1, const void* b1,
                                      const void* v, void* out, int N, int L, int Din,
                                      int heads, int dk, int A, float scale, void* stream) {
  const int D = heads * dk;
  if (N <= 0 || L != kL || Din <= 0 || Din % 4 != 0 || D % 4 != 0 || A <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (size_t(region0_floats(Din, dk)) + size_t(kL) * 3 * D);
  if (smem > size_t(g_max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  msa_encoder_pooled_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(wk), static_cast<const float*>(wv),
      static_cast<const float*>(bv), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(v), static_cast<float*>(out),
      Din, heads, dk, A, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* digat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
