// Word-embedding gradient as a sorted segment sum, fp32, for sm_90a
// (kernel D).
//
// Replaces the TPU kernel digat_tpu/ops/pallas/emb_grad.py
// (embedding_lookup's backward -> sorted_rowsum -> _rowsum_kernel). The
// gradient of table[tok] is dW[v] = sum of g[k] over the token slots k with
// tok[k] == v, and 0 for a row no token names.
//
// What bounds it on an H100: bytes. Every gradient row is read once (Ntok *
// D * 4 bytes) and every table row written once (V * D * 4); the adds are a
// fraction of an operation per byte.
//
// Design. The TPU kernel walked a host-built work list of (table tile,
// sorted chunk) pairs through scalar prefetch, because a TPU has no scatter
// atomics. Here the wrapper sorts the token stream on the device (stable
// sort; the permutation `perm` gives the slots in token order) and cuts the
// sorted stream into segments: a segment is a run of equal tokens inside
// one chunk of kChunk sorted slots, so a long run (the pad token of real
// titles) is spread over many chunks. `seg` is each sorted slot's segment.
//   1. emb_grad_segsum_kernel: one warp per chunk sums the gradient rows of
//      each of its segments (lanes over the D columns, float4 each) and
//      writes one partial row per segment.
//   2. emb_grad_rows_kernel: one warp per table row sums its segments'
//      partials in order (searchsorted bounds `first`, `last` of its run)
//      or writes zeros.
// No atomics: the result is the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 4;  // float4 columns per lane: D <= 4 * 32 * kMaxQ = 512

__global__ void __launch_bounds__(kThreads)
emb_grad_segsum_kernel(const float* __restrict__ g, const int64_t* __restrict__ perm,
                       const int64_t* __restrict__ seg, long long ntok, int D, int chunk,
                       float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long c = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long k0 = c * chunk;
  if (k0 >= ntok) return;
  const long long k1 = k0 + chunk < ntok ? k0 + chunk : ntok;
  const int nf4 = D / 4;
  float4 acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k = k0; k < k1; ++k) {
    const float4* row = reinterpret_cast<const float4*>(g + perm[k] * D);
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int f = lane + 32 * q;
      if (f < nf4) {
        const float4 v = row[f];
        acc[q].x += v.x;
        acc[q].y += v.y;
        acc[q].z += v.z;
        acc[q].w += v.w;
      }
    }
    const int64_t s = seg[k];
    if (k + 1 == k1 || seg[k + 1] != s) {
      float4* out = reinterpret_cast<float4*>(partial + s * D);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int f = lane + 32 * q;
        if (f < nf4) out[f] = acc[q];
        acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
emb_grad_rows_kernel(const float* __restrict__ partial, const int64_t* __restrict__ seg,
                     const int64_t* __restrict__ first, const int64_t* __restrict__ last,
                     long long V, int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long v = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  if (v >= V) return;
  const int nf4 = D / 4;
  float4 acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t f0 = first[v], f1 = last[v];
  if (f1 > f0) {
    for (int64_t s = seg[f0]; s <= seg[f1 - 1]; ++s) {
      const float4* row = reinterpret_cast<const float4*>(partial + s * D);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int f = lane + 32 * q;
        if (f < nf4) {
          const float4 p = row[f];
          acc[q].x += p.x;
          acc[q].y += p.y;
          acc[q].z += p.z;
          acc[q].w += p.w;
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + v * D);
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int f = lane + 32 * q;
    if (f < nf4) o[f] = acc[q];
  }
}

}  // namespace

// g [ntok, D] gradient rows; perm, seg [ntok] int64 (sorted-slot order);
// first, last [V] int64; partial [segments, D] scratch; out [V, D].
extern "C" int emb_grad_f32(const void* g, const void* perm, const void* seg, const void* first,
                            const void* last, void* partial, void* out, long long ntok,
                            long long V, int D, int chunk, void* stream) {
  if (ntok < 0 || V <= 0 || D <= 0 || D % 4 != 0 || D > 4 * 32 * kMaxQ || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (ntok + chunk - 1) / chunk;
  if (chunks > 0) {
    emb_grad_segsum_kernel<<<(chunks + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(seg), ntok, D, chunk, static_cast<float*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  emb_grad_rows_kernel<<<(V + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const int64_t*>(seg),
      static_cast<const int64_t*>(first), static_cast<const int64_t*>(last), V, D,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
