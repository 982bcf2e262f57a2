// Fused MSA news encoder, forward, fp32 and bf16, for sm_90a (kernel A).
//
// Replaces the TPU kernel digat_tpu/ops/pallas/msa_encoder.py
// (msa_encoder_pooled -> _call -> _fwd_kernel). Per title: word dropout of
// the embedded words (training), Q/K/V projections, 16-head UNMASKED
// softmax attention over the L <= 32 positions (pads attend, as in the
// reference), ReLU, then the masked tanh-MLP attention pool with the -1e9
// fill, giving one [D] vector. Heads stay unpadded (dk 25, D = 400).
//
// What bounds it on an H100: the two matrix products. Over M = N L rows
// the Q|K|V projection costs 2 M Din 3D FLOP and the pool's 2 M D A: at
// N 8,960 (M 286,720), Din 300, D 400, A 256 that is 265 GFLOP, against
// 15 GFLOP of attention and 0.36 GB of input. At 3xTF32 on the tensor cores
// (three TF32 products per fp32 product) the products alone take at least
// 1.6 ms; on the fp32 CUDA cores 4.0 ms.
//
// Design: the forward half of kernel A''s chain (msa_encoder_bwd.cu), on
// the caller's stream, with scratch in device memory that the wrapper
// allocates (msa_encoder_fwd_scratch_floats):
//   1. xd = dropout(x) (Philox by (seed, site) at counter (float4 index,
//      title), msa_title.cuh), written to scratch; without dropout xd is x.
//      The mask is never stored: kernel A' draws the same bits again.
//      Chosen over a load-side mask in the product's A operand: the product
//      reads each A tile once for each of its 10 tiles of 128 columns of
//      3D = 1,200, so a load-side mask would draw every Philox block 10
//      times (about 22 G integer operations at N 8,960, over 1 ms at the
//      card's int32 issue rate, taken from the product's own issue slots)
//      where this pass moves 0.69 GB in about 0.23 ms.
//   2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv]  (tc_gemm.cuh, kBias, kRN, BN 96).
//      Kernel A''s step 2 is the same product, split and tiles, also with
//      kRN, so the two q|k|v are the same bits. Why kRN: the tensor cores round their
//      accumulation toward zero, and the card-against-CPU check of a
//      training step holds the step-1 gradients of the graph encoder to 1e-3
//      of their scale. Those gradients pass kernel C's relu masks, which
//      flip wherever the forward's error moves a k1 + k2 + k3 across 0, each
//      flip moving a gradient entry by a whole a g term; with A's products
//      summed toward zero the worst read 5.4e-3 on an H100, against 3.8e-4
//      with the fp32 CUDA-core kernel this replaces.
//   3. msa_attn_fwd_kernel<false>, a block of 4 warps per (title, head)
//      (msa_title.cuh): h = relu(P v), written over the unit's q columns.
//   4. the pool logits (tc_gemm.cuh, kLogits, kRN, BN 96): tanh(h W1^T + b1)
//      times v, summed over each warp's 32 columns into lgpart [parts, M];
//      u [M, A] is never stored.
//   5. msa_pool_fwd_kernel, a warp per title: the logit of each position
//      summed from its parts in order, the masked softmax (-1e9 fill; an
//      all-pad title gives uniform weights), out[n] = sum_l alpha_l h_l
//      over l in order.
// The products run at 3xTF32 (tc_gemm.cuh), each 32-deep k-tile's sums
// added to the running sums rounding to nearest: fp32-class accuracy.
//
// No ReLU fix. Kernel A' recomputes the units whose pre-activations lie
// within rounding of 0 on the CUDA cores because the backward takes the
// ReLU's gradient (0 or the whole upstream term) from each pre-activation's
// sign. The forward's output is relu itself, which is continuous: a
// pre-activation within 1e-6 of 0 that rounds to the other side moves h by
// no more than that, inside the gate.
//
// bf16 (msa_encoder_pooled_bf16: x and the weight matrices bf16, the
// vectors and the output fp32, as the JAX kernel takes them at
// compute_dtype bfloat16): step 1 rounds each kept x / (1 - rate) to bf16
// once (round to nearest even), step 2 runs on the bf16 tensor cores
// (tc_gemm.cuh gemm_bf16_kernel: exact products, fp32 sums, kRN) and step 4
// at 2xTF32 (h fp32 split into two TF32 parts, W1 exact in one); q|k|v, h,
// the attention and the pool's softmax stay fp32. Against fp32 the products
// read half the weight bytes and the q|k|v product one pass in place of
// three. Its SASS issues HMMA.16816.F32.BF16 for step 2.
//
// Every reduction runs in a fixed order with no atomics: the same bits on
// every run. Limits, as kernel A''s: L 1 to 128, Din and D multiples of 4,
// dk <= 128, A a multiple of 4 up to 512: where the JAX package runs its
// kernel (group_size(heads, L, dk) > 0). A title of L < 32 runs on the first
// L lanes of the attention unit and of the pool's warp (msa_title.cuh); x,
// qkv and the logits keep L rows a title in global memory. Titles of 33 to
// 128, and heads of dk 65 to 128, run step 3 as msa_title.cuh's long unit
// (msa_attn_fwd_long_kernel<false>) and, past L 32, step 5 as
// msa_pool_fwd_long_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "msa_title.cuh"
#include "tc_gemm.cuh"

namespace {

// tile widths of the Q|K|V and pool products: kRN's second set of
// accumulators fits in the registers at 96 columns a block, not at 128
constexpr int kBNq = 96, kBNp = 96;

namespace tc = digat::tc;

// out[n] = sum_l alpha_l h[n, l], a warp per title: lane l < L takes
// alpha_l, then each lane sums float4 columns over l < L in order
template <int kFixedL>
__global__ void __launch_bounds__(kThreads)
msa_pool_fwd_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                    int parts,
                    const unsigned char* __restrict__ mask,  // [N, L]
                    const float* __restrict__ h, int ldh,    // [N*L, ldh]
                    float* __restrict__ out,                 // [N, D]
                    int N, int title_len, int D) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  const int L = kFixedL > 0 ? kFixedL : title_len;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  const bool present = kFull || lane < L;
  const size_t M = (size_t)N * L, row = (size_t)n * L + lane;
  const float alpha = pool_alpha(lgpart, parts, M, row, present, present && mask[row] != 0);
  float al[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) al[l] = __shfl_sync(0xffffffffu, alpha, l);
  const float* hn = h + (size_t)n * L * ldh;
  for (int c = lane; c < D / 4; c += 32) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      if (!kFull && l >= L) break;
      axpy4(al[l], __ldg(reinterpret_cast<const float4*>(hn + (size_t)l * ldh) + c), o);
    }
    reinterpret_cast<float4*>(out + (size_t)n * D)[c] = o;
  }
}

// The same for a title of 33 to 128 positions: lane l takes positions l,
// l + 32, ... of the softmax (pool_alpha_long), and the sum runs over l < L in
// order.
__global__ void __launch_bounds__(kThreads)
msa_pool_fwd_long_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                         int parts,
                         const unsigned char* __restrict__ mask,  // [N, L]
                         const float* __restrict__ h, int ldh,    // [N*L, ldh]
                         float* __restrict__ out,                 // [N, D]
                         int N, int L, int D) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  float al[kLongWarps];
  pool_alpha_long(lgpart, parts, (size_t)N * L, mask, n, L, lane, al);
  const float* hn = h + (size_t)n * L * ldh;
  for (int c0 = 0; c0 < D / 4; c0 += 32) {
    const int c = c0 + lane;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const float a = lane_value(al, l);  // every lane takes part in the shuffle
      if (c < D / 4) axpy4(a, __ldg(reinterpret_cast<const float4*>(hn + (size_t)l * ldh) + c), o);
    }
    if (c < D / 4) reinterpret_cast<float4*>(out + (size_t)n * D)[c] = o;
  }
}

// floats of each scratch array, in the order they sit in the scratch buffer
struct FwdScratch {
  size_t xd, qkv, lgpart;
  size_t total() const { return xd + qkv + lgpart; }
};

FwdScratch fwd_scratch_of(int N, int L, int Din, int D, int A, bool drop) {
  const size_t M = size_t(N) * L;
  auto a4 = [](size_t f) { return (f + 3) & ~size_t(3); };  // 16-byte aligned starts
  return FwdScratch{drop ? a4(M * Din) : 0, a4(M * 3 * D),
                    a4(size_t(tc::pool_parts<kBNp>(A)) * M)};
}

bool shapes_taken(int N, int L, int Din, int D, int dk, int A) {
  return N > 0 && L > 0 && L <= kLongL && Din > 0 && Din % 4 == 0 && D % 4 == 0 && dk > 0 &&
         dk <= kLongMaxDk && A > 0 && A % 4 == 0 && A <= 128 * kMaxA4;
}

}  // namespace

// Grants the products their shared memory on the current device. Called
// once per device, when the library is loaded.
extern "C" int msa_encoder_init() {
  cudaError_t e = tc::init<true, true, kBNq, tc::kBias, true>();
  if (e == cudaSuccess) e = tc::init<true, true, kBNp, tc::kLogits, true>();
  if (e == cudaSuccess) e = tc::init_bf16<kBNq, tc::kBias, true>();
  if (e == cudaSuccess) e = tc::init<true, true, kBNp, tc::kLogits, true, __nv_bfloat16>();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_fwd_long_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(float) * attn_fwd_long_floats(kLongL));
  return static_cast<int>(e);
}

// Floats of scratch that msa_encoder_pooled_f32 needs (0 if the shapes are
// not taken); `drop` is whether word dropout is on.
extern "C" long long msa_encoder_fwd_scratch_floats(int N, int L, int Din, int heads, int dk,
                                                    int A, int drop) {
  if (heads <= 0 || !shapes_taken(N, L, Din, heads * dk, dk, A)) return 0;
  return (long long)fwd_scratch_of(N, L, Din, heads * dk, A, drop != 0).total();
}

namespace {

// The forward for x and the weight matrices of type T (float or bf16).
template <typename T>
cudaError_t pooled(const T* x, const void* mask, const T* wqkv, const float* bqkv, const T* w1,
                   const float* b1, const float* v, float* out, float* scratch, int N, int L,
                   int Din, int heads, int dk, int A, float scale, unsigned thresh,
                   float drop_scale, unsigned seed, unsigned site, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int D = heads * dk;
  if (heads <= 0 || !shapes_taken(N, L, Din, D, dk, A)) return cudaErrorInvalidValue;
  const FwdScratch sz = fwd_scratch_of(N, L, Din, D, A, thresh != 0);
  T* xd = reinterpret_cast<T*>(scratch);
  float* qkv = scratch + sz.xd;
  float* lgpart = qkv + sz.qkv;
  const int M = N * L;
  cudaError_t e;

  // 1. xd = dropout(x); without dropout xd is x itself
  const T* xin = x;
  if (thresh) {
    dropout_apply_kernel<T><<<grid_1d((long long)M * Din / 4), kThreads, 0, st>>>(
        xin, xd, N, L * Din, thresh, drop_scale, seed, site);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    xin = xd;
  }
  // 2. qkv = xd [Wq|Wk|Wv]^T + [bq|0|bv]
  tc::Args a{};
  a.A = xin;
  a.B = wqkv;
  a.C = qkv;
  a.M = M;
  a.N = 3 * D;
  a.K = Din;
  a.lda = Din;
  a.ldb = Din;
  a.ldc = 3 * D;
  a.k_per_split = Din;
  a.bias = bqkv;
  if (kBf16) e = tc::gemm_bf16<kBNq, tc::kBias, true>(st, a);
  else e = tc::gemm<true, true, kBNq, tc::kBias, true>(st, a);
  if (e != cudaSuccess) return e;
  // 3. h = relu(P v) per unit, over q
  if (short_unit(L, dk)) {
    e = with_title_length(L, [&](auto fixed) {
      msa_attn_fwd_kernel<false, decltype(fixed)::value>
          <<<N * heads, kAttnThreads, sizeof(float) * attn_fwd_floats(dk, false), st>>>(
              qkv, nullptr, qkv, 3 * D, nullptr, nullptr, nullptr, L, heads, dk, scale);
      return cudaGetLastError();
    });
  } else {
    msa_attn_fwd_long_kernel<false>
        <<<N * heads, long_threads(L), sizeof(float) * attn_fwd_long_floats(L), st>>>(
            qkv, nullptr, qkv, 3 * D, nullptr, nullptr, nullptr, L, heads, dk, scale);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  // 4. lgpart = the v-product of tanh(h W1^T + b1), per warp column
  a = tc::Args{};
  a.A = qkv;  // h, over q: rows 3D apart
  a.B = w1;
  a.C = nullptr;
  a.M = M;
  a.N = A;
  a.K = D;
  a.lda = 3 * D;
  a.ldb = D;
  a.ldc = A;
  a.k_per_split = D;
  a.bias = b1;
  a.v = v;
  a.lgpart = lgpart;
  if ((e = tc::gemm<true, true, kBNp, tc::kLogits, true, T>(st, a)) != cudaSuccess) return e;
  // 5. the pool's softmax and the pooled vector
  if (L > kL) {
    msa_pool_fwd_long_kernel<<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
        lgpart, tc::pool_parts<kBNp>(A), static_cast<const unsigned char*>(mask), qkv, 3 * D,
        out, N, L, D);
    return cudaGetLastError();
  }
  return with_title_length(L, [&](auto fixed) {
    msa_pool_fwd_kernel<decltype(fixed)::value>
        <<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
            lgpart, tc::pool_parts<kBNp>(A), static_cast<const unsigned char*>(mask), qkv,
            3 * D, out, N, L, D);
    return cudaGetLastError();
  });
}

}  // namespace

// x [N, L, Din]; mask [N, L] (bytes); wqkv [3D, Din] (Wq, Wk, Wv stacked,
// nn.Linear layout); bqkv [3D] ([bq | 0 | bv]); w1 [A, D]; b1, v [A];
// out [N, D]. fp32 throughout.
extern "C" int msa_encoder_pooled_f32(const void* x, const void* mask, const void* wqkv,
                                      const void* bqkv, const void* w1, const void* b1,
                                      const void* v, void* out, void* scratch, int N, int L,
                                      int Din, int heads, int dk, int A, float scale,
                                      unsigned thresh, float drop_scale, unsigned seed,
                                      unsigned site, void* stream) {
  return static_cast<int>(pooled<float>(
      static_cast<const float*>(x), mask, static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(scratch), N, L, Din, heads, dk, A, scale, thresh, drop_scale, seed,
      site, static_cast<cudaStream_t>(stream)));
}

// The same with x, wqkv and w1 bf16 (bqkv, b1, v, out and scratch fp32).
extern "C" int msa_encoder_pooled_bf16(const void* x, const void* mask, const void* wqkv,
                                       const void* bqkv, const void* w1, const void* b1,
                                       const void* v, void* out, void* scratch, int N, int L,
                                       int Din, int heads, int dk, int A, float scale,
                                       unsigned thresh, float drop_scale, unsigned seed,
                                       unsigned site, void* stream) {
  return static_cast<int>(pooled<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), mask, static_cast<const __nv_bfloat16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(scratch), N, L, Din, heads, dk, A, scale, thresh, drop_scale, seed,
      site, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* digat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
