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
// sort of 32-bit keys: `ids` the sorted tokens, `perm` the slots in token
// order) and that is all the metadata there is. The sorted stream is cut
// into chunks of `chunk` slots, one warp each.
//   1. emb_grad_chunks_kernel: the warp reads its chunk's ids and perm 32 at
//      a time (one per lane, then broadcast by shuffles) and keeps kAhead
//      gradient rows' float4 loads in flight per lane while it sums each run
//      of equal ids in slot order. A run that lies wholly inside the chunk
//      writes its row of `out` directly. A run that crosses the chunk's
//      start writes its piece to partial[2c], one that crosses its end (and
//      began inside it) to partial[2c + 1]. The warp also writes zeros to
//      the table rows that no token names: those between the id before each
//      run that starts in its chunk and that run's id, and, in the last
//      chunk, those after the last id. So every row of `out` is written once.
//   2. emb_grad_runs_kernel: a warp per chunk whose last run began in it
//      and goes on into the next chunk finds the run's last slot by a
//      galloping search in `ids` and sums the run's pieces (partial[2c + 1], then
//      partial[2c'] of every later chunk it covers) in order, alone when
//      there are at most kShortRun of them. A longer run (the pad token's)
//      is summed by the warp's whole block: one contiguous range of pieces
//      per warp, then the warps' sums in warp order.
// No atomics: the result is the same bits on every run.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;         // gradient rows in flight per lane (chunk pass)
constexpr int kRunWarps = 16;     // warps of a block in the runs pass
constexpr int kRunAhead = 8;      // partial rows in flight per lane (runs pass)
constexpr int kShortRun = 32;     // pieces a warp sums alone in the runs pass
constexpr int kMaxF4 = 128;       // float4 columns: D <= 512

template <int Q>
__device__ __forceinline__ void zero_rows(float* out, int lo, int hi, int nf4, int lane) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = lo; r < hi; ++r) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)r * nf4 * 4);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int f = lane + 32 * q;
      if (f < nf4) o[f] = z;
    }
  }
}

// Q float4 columns per lane: D <= 128 * Q
template <int Q>
__global__ void __launch_bounds__(kThreads)
emb_grad_chunks_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                       const int64_t* __restrict__ perm, long long ntok, int V, int D, int chunk,
                       float* __restrict__ partial, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long c = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long k0 = c * chunk;
  if (k0 >= ntok) return;
  const long long k1 = k0 + chunk < ntok ? k0 + chunk : ntok;
  const int nf4 = D / 4;
  const int before = k0 > 0 ? ids[k0 - 1] : -1;  // the id before the chunk
  const int after = k1 < ntok ? ids[k1] : V;     // the id after it (V: none)
  float4 acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  bool from_before = true;  // the current run holds the chunk's first slot
  int carry = before;       // the id of the slot before this group of 32
  for (long long base = k0; base < k1; base += 32) {
    const int n = int(k1 - base < 32 ? k1 - base : 32);
    const int my_id = lane < n ? ids[base + lane] : INT_MAX;
    const long long my_perm = lane < n ? perm[base + lane] : 0;
    int prev_id = __shfl_up_sync(0xffffffffu, my_id, 1);
    if (lane == 0) prev_id = carry;
    const int beyond = base + n < k1 ? ids[base + n] : after;  // the id after this group
    // rows no token names: the gap below each run that starts in this group
    unsigned starts = __ballot_sync(0xffffffffu, lane < n && my_id != prev_id);
    while (starts) {
      const int b = __ffs(starts) - 1;
      starts &= starts - 1;
      zero_rows<Q>(out, __shfl_sync(0xffffffffu, prev_id, b) + 1,
                   __shfl_sync(0xffffffffu, my_id, b), nf4, lane);
    }
    for (int j0 = 0; j0 < n; j0 += kAhead) {
      float4 v[kAhead][Q];
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const long long p = __shfl_sync(0xffffffffu, my_perm, (j0 + r) & 31);
        const float4* row = reinterpret_cast<const float4*>(g + p * D);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int f = lane + 32 * q;
          v[r][q] = (j0 + r < n && f < nf4) ? __ldg(row + f) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const int j = j0 + r;
        const int id = __shfl_sync(0xffffffffu, my_id, j & 31);
        const int nid_in = __shfl_sync(0xffffffffu, my_id, (j + 1) & 31);
        if (j >= n) break;  // uniform across the warp
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          acc[q].x += v[r][q].x;
          acc[q].y += v[r][q].y;
          acc[q].z += v[r][q].z;
          acc[q].w += v[r][q].w;
        }
        const bool last = base + j + 1 == k1;  // the chunk's last slot
        if (last || (j + 1 < n ? nid_in : beyond) != id) {  // the run's piece ends here
          const bool head = from_before && before == id;
          const bool tail = !head && last && after == id;
          float* dst = head ? partial + (2 * c) * D
                            : (tail ? partial + (2 * c + 1) * D : out + (size_t)id * D);
          float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int f = lane + 32 * q;
            if (f < nf4) d4[f] = acc[q];
            acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          from_before = false;
        }
      }
    }
    carry = __shfl_sync(0xffffffffu, my_id, (n - 1) & 31);
  }
  if (k1 == ntok) zero_rows<Q>(out, carry + 1, V, nf4, lane);  // rows past the last id
}

// acc += the pieces t0 .. t1 - 1 of the run that begins in chunk c, in order:
// piece 0 is partial[2c + 1], piece t the head piece partial[2(c + t)]
template <int Q>
__device__ __forceinline__ void sum_pieces(const float* __restrict__ partial, long long c,
                                           long long t0, long long t1, int nf4, int lane,
                                           float4 (&acc)[Q]) {
  for (long long b = t0; b < t1; b += kRunAhead) {
    float4 v[kRunAhead][Q];
#pragma unroll
    for (int r = 0; r < kRunAhead; ++r) {
      const long long t = b + r;
      const float4* row =
          reinterpret_cast<const float4*>(partial + (t == 0 ? 2 * c + 1 : 2 * (c + t)) * nf4 * 4);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int f = lane + 32 * q;
        v[r][q] = (t < t1 && f < nf4) ? row[f] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < kRunAhead; ++r) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[q].x += v[r][q].x;
        acc[q].y += v[r][q].y;
        acc[q].z += v[r][q].z;
        acc[q].w += v[r][q].w;
      }
    }
  }
}

// A warp per chunk: if the chunk's last run began in it and goes on, the
// warp sums that run's pieces alone when they are at most kShortRun, and
// otherwise leaves it to the whole block, whose warps take one contiguous
// range of pieces each and whose sums are then added in warp order.
template <int Q>
__global__ void __launch_bounds__(kRunWarps * 32)
emb_grad_runs_kernel(const float* __restrict__ partial, const int* __restrict__ ids,
                     long long ntok, int D, int chunk, float* __restrict__ out) {
  __shared__ __align__(16) float4 red[kRunWarps][kMaxF4];
  __shared__ long long long_end[kRunWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nf4 = D / 4;
  const long long chunks = (ntok + chunk - 1) / chunk;
  const long long c = blockIdx.x * (long long)kRunWarps + warp;
  long long end = -1;  // the first slot past the run that begins in chunk c and goes on
  int id = 0;
  if (c < chunks) {
    const long long k0 = c * chunk, k1 = k0 + chunk < ntok ? k0 + chunk : ntok;
    id = ids[k1 - 1];
    if (k1 < ntok && ids[k1] == id && !(k0 > 0 && ids[k0 - 1] == id)) {
      // galloping search: a short run takes a few loads, the pad run ~2 log
      long long lo = k1 + 1, hi = ntok, step = 1;  // ids[lo - 1] == id
      while (lo < ntok) {
        const long long probe = lo + step - 1 < ntok ? lo + step - 1 : ntok - 1;
        if (ids[probe] != id) {
          hi = probe;
          break;
        }
        lo = probe + 1;
        step *= 2;
      }
      while (lo < hi) {  // the first slot in [lo, hi] past the run
        const long long mid = (lo + hi) >> 1;
        if (ids[mid] == id) lo = mid + 1;
        else hi = mid;
      }
      end = lo;
    }
  }
  const long long pieces = end < 0 ? 0 : (end - 1) / chunk - c + 1;
  if (pieces > 0 && pieces <= kShortRun) {
    float4 acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    sum_pieces<Q>(partial, c, 0, pieces, nf4, lane, acc);
    float4* o = reinterpret_cast<float4*>(out + (size_t)id * D);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int f = lane + 32 * q;
      if (f < nf4) o[f] = acc[q];
    }
  }
  if (lane == 0) long_end[warp] = pieces > kShortRun ? end : -1;
  __syncthreads();
  for (int wv = 0; wv < kRunWarps; ++wv) {  // the block's long runs, one at a time
    const long long e = long_end[wv];
    if (e < 0) continue;  // the same for every thread of the block
    const long long cc = blockIdx.x * (long long)kRunWarps + wv;
    const int rid = ids[(cc + 1) * chunk - 1];
    const long long np = (e - 1) / chunk - cc + 1;
    float4 acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    sum_pieces<Q>(partial, cc, np * warp / kRunWarps, np * (warp + 1) / kRunWarps, nf4, lane,
                  acc);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int f = lane + 32 * q;
      if (f < nf4) red[warp][f] = acc[q];
    }
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + (size_t)rid * D);
    for (int f = threadIdx.x; f < nf4; f += kRunWarps * 32) {
      float4 s = red[0][f];
#pragma unroll
      for (int w = 1; w < kRunWarps; ++w) {
        s.x += red[w][f].x;
        s.y += red[w][f].y;
        s.z += red[w][f].z;
        s.w += red[w][f].w;
      }
      o[f] = s;
    }
    __syncthreads();
  }
}

__global__ void emb_grad_zero_kernel(float4* out, long long n4) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads)
    out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int Q>
cudaError_t launch(const float* g, const int* ids, const int64_t* perm, float* partial,
                   float* out, long long ntok, int V, int D, int chunk, cudaStream_t st) {
  const long long chunks = (ntok + chunk - 1) / chunk;
  emb_grad_chunks_kernel<Q><<<(chunks + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      g, ids, perm, ntok, V, D, chunk, partial, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  emb_grad_runs_kernel<Q><<<(chunks + kRunWarps - 1) / kRunWarps, kRunWarps * 32, 0, st>>>(
      partial, ids, ntok, D, chunk, out);
  return cudaGetLastError();
}

}  // namespace

// g [ntok, D] gradient rows; ids [ntok] int32, the sorted tokens; perm
// [ntok] int64, the slot of each sorted position (a stable sort); partial
// [2 * ceil(ntok / chunk), D] scratch; out [V, D].
extern "C" int emb_grad_f32(const void* g, const void* ids, const void* perm, void* partial,
                            void* out, long long ntok, int V, int D, int chunk, void* stream) {
  if (ntok < 0 || V <= 0 || D <= 0 || D % 4 != 0 || D > 4 * kMaxF4 || chunk <= 0 ||
      chunk % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (ntok == 0) {
    const long long n4 = (long long)V * D / 4;
    const long long blocks = (n4 + kThreads - 1) / kThreads;
    emb_grad_zero_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0, st>>>(
        reinterpret_cast<float4*>(o), n4);
    return static_cast<int>(cudaGetLastError());
  }
  const float* fg = static_cast<const float*>(g);
  const int* fi = static_cast<const int*>(ids);
  const int64_t* fp = static_cast<const int64_t*>(perm);
  float* fpart = static_cast<float*>(partial);
  const int q = (D / 4 + 31) / 32;
  cudaError_t e;
  if (q == 1) e = launch<1>(fg, fi, fp, fpart, o, ntok, V, D, chunk, st);
  else if (q == 2) e = launch<2>(fg, fi, fp, fpart, o, ntok, V, D, chunk, st);
  else if (q == 3) e = launch<3>(fg, fi, fp, fpart, o, ntok, V, D, chunk, st);
  else e = launch<4>(fg, fi, fp, fpart, o, ntok, V, D, chunk, st);
  return static_cast<int>(e);
}
