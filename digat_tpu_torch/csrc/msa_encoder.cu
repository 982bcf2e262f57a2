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
// compute_dtype bfloat16): q|k|v, h, the attention and the pool's softmax
// stay fp32, and both products run on wgmma fed by the TMA (tc_wgmma.cuh):
//   1. step 1 rounds each kept x / (1 - rate) to bf16 once (round to
//      nearest even) into rows of ld8(Din) elements (16 bytes apart, as the
//      TMA reads them); without dropout x is read in place where Din % 8 == 0
//      and copied to such rows otherwise (relayout_kernel), as are Wq|Wk|Wv
//      and W1 where Din or D % 8;
//   2. q|k|v is one pass of exact bf16 products summed in fp32 over 64-deep
//      k-tiles (kRN), the same instance as kernel A''s bf16 recompute
//      (wg::gemm<wg::kNx, 64, ..., 1, 1, kBias>): the same bits;
//   3. the short unit's attention is msa_attn_fwd_group_kernel (above): a
//      block per (title, four heads), 16-byte loads of the heads' q|k|v
//      columns, a lane per query row with its scores in registers; it
//      writes h only as its three bf16 planes (hi, mid, lo: tc_wgmma.cuh),
//      the pool logits' operand. The long unit (L 33-128, dk 65-128) runs
//      msa_attn_fwd_long_kernel (h over q) and a split3_kernel pass;
//   4. the pool logits are three bf16 passes of h's planes against W1 (kRN,
//      kLogits: kPool's epilogue without u's store), one logit part a
//      128-wide tile column, summed in the order of kernel A''s bf16 u
//      product;
//   5. the pool as for fp32, h read as hi + mid + lo from its planes (its
//      fp32 value) up to L 32, from over q past it.
// What bounds it: the q|k|v product's 0.2 TFLOP at one bf16 pass, the pool
// logits' three passes and the attention's 15 GFLOP on the CUDA cores take
// 0.6 ms at the card's peaks at N 8,960; the attention stage moves 2.1 GB
// (q|k|v read, h's planes written), 0.62 ms at 3.35 TB/s. Its SASS issues
// HGMMA for steps 2 and 4.
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

#include <initializer_list>
#include <type_traits>

#include "msa_title.cuh"
#include "tc_gemm.cuh"
#include "tc_wgmma.cuh"

namespace {

// tile widths of the Q|K|V and pool products: kRN's second set of
// accumulators fits in the registers at 96 columns a block, not at 128
constexpr int kBNq = 96, kBNp = 96;

namespace tc = digat::tc;
namespace wg = digat::wg;

// ---------------------------------------------------------------------------
// The bf16 instance's attention stage for short units (L <= 32, a head's
// row within 16 float4s: group_unit): a block per (title, group of
// kGroupHeads heads), a warp per head, a lane per position. One thread has
// the TMA copy each head's q, k and v rows of the title into shared memory,
// one box of L rows by group_stride(dk) columns from the head's first
// column rounded down to a float4 (the TMA starts a box on 16 bytes), so
// that head's data sit `mis` = (head dk) % 4 floats into 16-byte rows,
// [3][head][32][group_stride(dk)], with its neighbours' columns (or zeros
// past 3D) around them; the q, k and v rows of one head share its `mis`,
// as D % 4 == 0. All boxes complete on one mbarrier; no thread spends a
// register or an instruction on the copy. Lane i then holds its query row
// in registers, zero outside the head's columns, and its 32 scores: the
// scores over the keys j < L as float4 dot products over the whole rows
// (the zeros take the neighbours' columns out; each key row read by the
// whole warp at once, a broadcast), the row's softmax with no exchange
// between lanes, and h_i = relu(sum_j p_ij v_j) over the value rows the
// same way (columns outside the head are not used): four FMAs a
// shared-memory read, no barrier between the warps. h goes back over the
// lane's q row, at the same shift; then the block writes each row of the
// group's h out, a warp a row, as the three bf16 planes of the pool logits'
// wgmma operand (8-byte stores of each plane; no split3_kernel pass), which
// the pool reads too: hi + mid + lo is h again (tc_wgmma.cuh), so no fp32 h
// is written.
// ---------------------------------------------------------------------------
constexpr int kGroupHeads = 4;
constexpr int kGroupThreads = 32 * kGroupHeads;

// float4s of a head row in the boxes: dk and the largest shift (3 for an
// odd dk, 2 for dk % 4 == 2, 0 for dk % 4 == 0)
__host__ __device__ inline int group_row_quads(int dk) {
  return (dk + (dk % 2 ? 3 : dk % 4) + 3) / 4;
}

// Row stride of the boxes in shared memory (and their width): an odd number
// of float4s, so that lanes reading their own rows hit distinct bank quads.
__host__ __device__ inline int group_stride(int dk) {
  const int g = group_row_quads(dk);
  return 4 * (g % 2 ? g : g + 1);
}

// Whether a unit of the bf16 instance runs msa_attn_fwd_group_kernel (else
// msa_title.cuh's long unit and a split3_kernel pass).
__host__ __device__ inline bool group_unit(int L, int dk) {
  return L <= kL && group_row_quads(dk) <= 16;
}

// Bytes of msa_attn_fwd_group_kernel's shared memory: q, k and v rows of
// the block's heads, 128 bytes to align them for the TMA, and the mbarrier.
__host__ __device__ inline int attn_group_bytes(int dk) {
  return 4 * 3 * kGroupHeads * kL * group_stride(dk) + 128 + 8;
}

// The float4s of a head row that an instance holds in registers: 7 (dk up
// to 25, the production's) or 16.
__host__ __device__ inline int group_quads(int dk) { return group_row_quads(dk) <= 7 ? 7 : 16; }

template <int kFixedL, int kG>
__global__ void __launch_bounds__(kGroupThreads, kG <= 7 ? 5 : 2)
msa_attn_fwd_group_kernel(const __grid_constant__ CUtensorMap rows,  // qkv [N*L][3D] fp32
                          __nv_bfloat16* __restrict__ h3,            // [3][N*L][ld8(D)] out
                          int title_len, int heads, int dk, float scale) {
  constexpr bool kFull = kFixedL == kL;  // no slot past L
  constexpr int kR = kG <= 8 ? 1 : 2;    // float4 columns of a group row a lane: W4 <= 32 kR
  const int L = kFixedL > 0 ? kFixedL : title_len;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw), base = (raw + 127u) & ~127u;
  float* smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int RS = group_stride(dk), HS = kL * RS, TS = kGroupHeads * HS, D = heads * dk;
  const uint32_t bar = base + 4u * 3 * TS;
  const int groups = (heads + kGroupHeads - 1) / kGroupHeads;
  const int n = blockIdx.x / groups, h0 = (blockIdx.x - n * groups) * kGroupHeads;
  const int nh = min(kGroupHeads, heads - h0), W4 = nh * dk / 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    wg::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // each head's q, k and v rows: 3 nh boxes from 16-byte starts
    wg::mbar_expect_tx(bar, 3 * nh * L * RS * 4);
    for (int t = 0; t < 3; ++t)
      for (int hh = 0; hh < nh; ++hh)
        wg::tma_load(base + 4u * (t * TS + hh * HS), &rows, bar,
                     (t * D + (h0 + hh) * dk) & ~3, n * L, 0);
  }
  // shared-memory offsets (head, shifted column) of the four elements of
  // each of this lane's float4 columns of a group row
  int off[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane + 32 * r) + e, hh = c / dk;
      off[r][e] = hh * HS + ((h0 + hh) * dk) % 4 + c - hh * dk;
    }
  wg::mbar_wait(bar, 0);

  if (w < nh) {  // head h0 + w; lane i a query row (lanes past L idle in effect)
    float* qs = smem + w * HS;
    const float* ks = qs + TS;
    const float* vs = ks + TS;
    const int G = RS / 4, mis = ((h0 + w) * dk) % 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float s[kL];
    {
      float4 q[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        q[g] = g < G ? *reinterpret_cast<const float4*>(qs + lane * RS + 4 * g) : zero;
        // 0 outside the head's columns [mis, mis + dk): they hold its neighbours'
        const int p = 4 * g - mis;
        if (p < 0 || p >= dk) q[g].x = 0.f;
        if (p + 1 < 0 || p + 1 >= dk) q[g].y = 0.f;
        if (p + 2 < 0 || p + 2 >= dk) q[g].z = 0.f;
        if (p + 3 < 0 || p + 3 >= dk) q[g].w = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        float a = 0.f;
        if (kFull || j < L) {
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < G) a = dot4(q[g], *reinterpret_cast<const float4*>(ks + j * RS + 4 * g), a);
        }
        s[j] = a * scale;
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kL; ++j)
      if (kFull || j < L) m = fmaxf(m, s[j]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      s[j] = kFull || j < L ? expf(s[j] - m) : 0.f;
      l += s[j];
    }
    const float inv = 1.f / l;
    float4 o[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) o[g] = zero;
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      if (kFull || j < L) {
        const float p = s[j] * inv;
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < G) axpy4(p, *reinterpret_cast<const float4*>(vs + j * RS + 4 * g), o[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(qs + lane * RS + 4 * g) =
            make_float4(fmaxf(o[g].x, 0.f), fmaxf(o[g].y, 0.f), fmaxf(o[g].z, 0.f),
                        fmaxf(o[g].w, 0.f));
  }
  __syncthreads();

  // the group's h rows out as the three bf16 planes
  const size_t ld = wg::ld8(D), plane = (size_t)(gridDim.x / groups) * L * ld;
  __nv_bfloat16* pdst = h3 + (size_t)n * L * ld + h0 * dk;
  for (int i = w; i < L; i += kGroupHeads) {
    const float* hs = smem + i * RS;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int c4 = lane + 32 * r;
      if (c4 < W4)
        wg::store3x4(pdst + i * ld + 4 * c4, plane,
                     make_float4(hs[off[r][0]], hs[off[r][1]], hs[off[r][2]], hs[off[r][3]]));
    }
  }
}

// The 3-d map (3D columns, N L rows, 1) of the fp32 qkv that
// msa_attn_fwd_group_kernel reads: boxes of group_stride(dk) columns by L
// rows, no swizzle.
inline bool make_rows_map(CUtensorMap* map, const float* qkv, int M, int D, int dk, int L) {
  if (!wg::encode_tiled() || reinterpret_cast<uintptr_t>(qkv) % 16) return false;
  const cuuint64_t dims[3] = {cuuint64_t(3 * D), cuuint64_t(M), 1};
  const cuuint64_t strides[2] = {cuuint64_t(3 * D) * 4, cuuint64_t(3 * D) * 4 * M};
  const cuuint32_t box[3] = {cuuint32_t(group_stride(dk)), cuuint32_t(L), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return wg::encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(qkv),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Calls f(std::integral_constant<int, kG>{}) with the instance's float4
// columns a head row for dk.
template <typename F>
inline cudaError_t with_head_width(int dk, F&& f) {
  if (group_quads(dk) == 7) return f(std::integral_constant<int, 7>{});
  return f(std::integral_constant<int, 16>{});
}

// out[n] = sum_l alpha_l h[n, l], a warp per title: lane l < L takes
// alpha_l, then each lane sums float4 columns over l < L in order. kPlanes
// (the bf16 instance): h is read as its three bf16 planes (`h3`, rows ldh
// apart, N L rows a plane), h = (hi + mid) + lo, which is h's fp32 value;
// where D % 8 == 0 a lane takes eight columns, 16-byte loads of each plane.
template <int kFixedL, bool kPlanes = false>
__global__ void __launch_bounds__(kThreads)
msa_pool_fwd_kernel(const float* __restrict__ lgpart,       // [parts, N*L]
                    int parts,
                    const unsigned char* __restrict__ mask,  // [N, L]
                    const float* __restrict__ h,             // [N*L, ldh]
                    const __nv_bfloat16* __restrict__ h3,    // kPlanes: [3][N*L][ldh]
                    int ldh,
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
  const __nv_bfloat16* pn = h3 + (size_t)n * L * ldh;
  if (kPlanes && D % 8 == 0) {
    for (int c = lane; c < D / 8; c += 32) {
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        if (!kFull && l >= L) break;
        const __nv_bfloat16* p = pn + (size_t)l * ldh + 8 * c;
        const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p)),
                    mid = __ldg(reinterpret_cast<const uint4*>(p + M * ldh)),
                    lo = __ldg(reinterpret_cast<const uint4*>(p + 2 * M * ldh));
        const uint32_t a[4] = {hi.x, hi.y, hi.z, hi.w}, b[4] = {mid.x, mid.y, mid.z, mid.w},
                       d[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = e / 2, sh = e % 2 ? 16 : 0;
          const float hv = digat::bf16_bits_to_float((a[k] >> sh) & 0xffffu) +
                           digat::bf16_bits_to_float((b[k] >> sh) & 0xffffu) +
                           digat::bf16_bits_to_float((d[k] >> sh) & 0xffffu);
          o[e] = fmaf(al[l], hv, o[e]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(out + (size_t)n * D + 8 * c);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    return;
  }
  for (int c = lane; c < D / 4; c += 32) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      if (!kFull && l >= L) break;
      float4 hv;
      if (kPlanes) {
        const __nv_bfloat16* p = pn + (size_t)l * ldh + 4 * c;
        const float4 hi = digat::load4(p), mid = digat::load4(p + M * ldh),
                     lo = digat::load4(p + 2 * M * ldh);
        hv = make_float4(hi.x + mid.x + lo.x, hi.y + mid.y + lo.y, hi.z + mid.z + lo.z,
                         hi.w + mid.w + lo.w);
      } else {
        hv = __ldg(reinterpret_cast<const float4*>(hn + (size_t)l * ldh) + c);
      }
      axpy4(al[l], hv, o);
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

// Parts of the pool logits of A columns: tc_gemm.cuh's per warp column
// (fp32), one a wgmma tile column (bf16, as kernel A''s u product).
int logit_parts(int A, bool bf16) {
  return bf16 ? (A + wg::kN - 1) / wg::kN : tc::pool_parts<kBNp>(A);
}

// floats holding n bf16 elements
inline size_t bf16_floats(long long n) { return size_t((n + 1) / 2); }

// floats of each scratch array, in the order they sit in the scratch buffer;
// the bf16 instance's wgmma operands last (0 for fp32): h's three planes and
// the weight copies with 16-byte rows (where Din or D % 8); its xd also
// holds x with 16-byte rows where Din % 8 and there is no dropout
struct FwdScratch {
  size_t xd, qkv, lgpart, h3 = 0, wqkvp = 0, w1p = 0;
  size_t total() const { return xd + qkv + lgpart + h3 + wqkvp + w1p; }
};

FwdScratch fwd_scratch_of(int N, int L, int Din, int D, int A, bool drop, bool bf16) {
  const long long M = (long long)N * L;
  auto a4 = [](size_t f) { return (f + 3) & ~size_t(3); };  // 16-byte aligned starts
  if (!bf16)
    return FwdScratch{drop ? a4(M * Din) : 0, a4(M * 3 * D), a4(size_t(logit_parts(A, false)) * M)};
  FwdScratch s{drop || Din % 8 ? a4(bf16_floats(M * wg::ld8(Din))) : 0, a4(M * 3 * D),
               a4(size_t(logit_parts(A, true)) * M)};
  s.h3 = a4(bf16_floats(3 * M * wg::ld8(D)));
  s.wqkvp = Din % 8 ? a4(bf16_floats(3LL * D * wg::ld8(Din))) : 0;
  s.w1p = D % 8 ? a4(bf16_floats((long long)A * wg::ld8(D))) : 0;
  return s;
}

bool shapes_taken(int N, int L, int Din, int D, int dk, int A) {
  return N > 0 && L > 0 && L <= kLongL && Din > 0 && Din % 4 == 0 && D % 4 == 0 && dk > 0 &&
         dk <= kLongMaxDk && A > 0 && A % 4 == 0 && A <= 128 * kMaxA4;
}

}  // namespace

// Grants the products and the attention kernels their shared memory on the
// current device. Called once per device, when the library is loaded.
extern "C" int msa_encoder_init() {
  cudaError_t e = tc::init<true, true, kBNq, tc::kBias, true>();
  if (e == cudaSuccess) e = tc::init<true, true, kBNp, tc::kLogits, true>();
  // the bf16 instance: q|k|v and the pool logits on wgmma
  if (e == cudaSuccess) e = wg::init<wg::kNx, 64, true, true, 1, 1, tc::kBias>();
  if (e == cudaSuccess) e = wg::init<wg::kN, 64, true, true, 3, 1, tc::kLogits>();
  for (int L : {32, 16, 0})
    for (int dk : {28, 64})
      if (e == cudaSuccess)
        e = with_title_length(L, [&](auto fixed) {
          return with_head_width(dk, [&](auto quads) {
            return cudaFuncSetAttribute(
                msa_attn_fwd_group_kernel<decltype(fixed)::value, decltype(quads)::value>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, attn_group_bytes(dk));
          });
        });
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(msa_attn_fwd_long_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(float) * attn_fwd_long_floats(kLongL));
  return static_cast<int>(e);
}

// Floats of scratch that msa_encoder_pooled_f32 (bf16 0) or
// msa_encoder_pooled_bf16 (bf16 1) needs (0 if the shapes are not taken);
// `drop` is whether word dropout is on.
extern "C" long long msa_encoder_fwd_scratch_floats(int N, int L, int Din, int heads, int dk,
                                                    int A, int drop, int bf16) {
  if (heads <= 0 || !shapes_taken(N, L, Din, heads * dk, dk, A)) return 0;
  return (long long)fwd_scratch_of(N, L, Din, heads * dk, A, drop != 0, bf16 != 0).total();
}

namespace {

// The forward for x and the weight matrices of type T (float or bf16).
template <typename T>
cudaError_t pooled(const T* x, const void* mask, const T* wqkv, const float* bqkv, const T* w1,
                   const float* b1, const float* v, float* out, float* scratch, int N, int L,
                   int Din, int heads, int dk, int A, float scale, unsigned thresh,
                   float drop_scale, unsigned seed, unsigned site, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using bf16 = __nv_bfloat16;
  const int D = heads * dk;
  if (heads <= 0 || !shapes_taken(N, L, Din, D, dk, A)) return cudaErrorInvalidValue;
  const FwdScratch sz = fwd_scratch_of(N, L, Din, D, A, thresh != 0, kBf16);
  T* xd = reinterpret_cast<T*>(scratch);
  float* qkv = scratch + sz.xd;
  float* lgpart = qkv + sz.qkv;
  bf16* h3 = reinterpret_cast<bf16*>(lgpart + sz.lgpart);
  bf16* wqkvp = reinterpret_cast<bf16*>(lgpart + sz.lgpart + sz.h3);
  bf16* w1p = reinterpret_cast<bf16*>(lgpart + sz.lgpart + sz.h3 + sz.wqkvp);
  const int M = N * L, parts = logit_parts(A, kBf16);
  const bool short_path = short_unit(L, dk), group_path = kBf16 && group_unit(L, dk);
  cudaError_t e;

  // 1. xd = dropout(x); without dropout xd is x itself. bf16: rows of
  // ld8(Din) elements (x copied to such rows in step 2 where Din % 8 and
  // there is no dropout)
  const T* xin = x;
  const int ldx = kBf16 ? wg::ld8(Din) : Din;
  if (thresh) {
    (ldx != Din ? dropout_apply_kernel<T, true> : dropout_apply_kernel<T, false>)
        <<<grid_1d((long long)M * Din / 4), kThreads, 0, st>>>(xin, xd, N, L * Din, Din, ldx,
                                                              thresh, drop_scale, seed, site);
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
  if constexpr (kBf16) {  // one bf16 pass on wgmma, kernel A''s instance
    if (!thresh && Din % 8) {
      wg::relayout_kernel<false><<<wg::copy_blocks((long long)M * Din / 4), wg::kCopyThreads, 0,
                                   st>>>(x, Din, M, Din, xd);
      xin = xd;
    }
    const T* wq = wqkv;
    if (Din % 8) {
      wg::relayout_kernel<false><<<wg::copy_blocks(3LL * D * Din / 4), wg::kCopyThreads, 0,
                                   st>>>(wqkv, Din, 3 * D, Din, wqkvp);
      wq = wqkvp;
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = wg::gemm<wg::kNx, 64, true, true, 1, 1, tc::kBias>(
        st, wg::Operand{xin, M, Din, ldx, (long long)M * ldx},
        wg::Operand{wq, 3 * D, Din, wg::ld8(Din), 3LL * D * wg::ld8(Din)}, a);
  } else {
    e = tc::gemm<true, true, kBNq, tc::kBias, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 3. h = relu(P v) per unit, over q (bf16: as h's three planes; the long
  // unit writes h over q, then its planes apart)
  if (group_path) {
    const int groups = (heads + kGroupHeads - 1) / kGroupHeads;
    CUtensorMap rows;
    if (!make_rows_map(&rows, qkv, M, D, dk, L)) return cudaErrorInvalidValue;
    e = with_title_length(L, [&](auto fixed) {
      return with_head_width(dk, [&](auto quads) {
        msa_attn_fwd_group_kernel<decltype(fixed)::value, decltype(quads)::value>
            <<<N * groups, kGroupThreads, attn_group_bytes(dk), st>>>(rows, h3, L, heads, dk,
                                                                     scale);
        return cudaGetLastError();
      });
    });
  } else if (short_path && !kBf16) {
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
    if (kBf16 && e == cudaSuccess) {  // the long unit writes h alone: its planes apart
      // (a bf16 unit of L <= 32 whose head row takes more than 16 float4s, dk 63, runs here)
      wg::split3_kernel<<<wg::copy_blocks((long long)M * D / 4), wg::kCopyThreads, 0, st>>>(
          qkv, 3 * D, h3, M, D);
      e = cudaGetLastError();
    }
  }
  if (e != cudaSuccess) return e;
  // 4. lgpart = the v-product of tanh(h W1^T + b1), per warp column (bf16:
  // per wgmma tile column, h as three bf16 planes against W1, three passes)
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
  if constexpr (kBf16) {
    const T* w1r = w1;
    if (D % 8) {
      wg::relayout_kernel<false><<<wg::copy_blocks((long long)A * D / 4), wg::kCopyThreads, 0,
                                   st>>>(w1, D, A, D, w1p);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      w1r = w1p;
    }
    e = wg::gemm<wg::kN, 64, true, true, 3, 1, tc::kLogits>(
        st, wg::Operand{h3, M, D, wg::ld8(D), (long long)M * wg::ld8(D)},
        wg::Operand{w1r, A, D, wg::ld8(D), (long long)A * wg::ld8(D)}, a);
  } else {
    e = tc::gemm<true, true, kBNp, tc::kLogits, true>(st, a);
  }
  if (e != cudaSuccess) return e;
  // 5. the pool's softmax and the pooled vector
  if (L > kL) {
    msa_pool_fwd_long_kernel<<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
        lgpart, parts, static_cast<const unsigned char*>(mask), qkv, 3 * D, out, N, L, D);
    return cudaGetLastError();
  }
  return with_title_length(L, [&](auto fixed) {  // bf16: h from its planes
    (kBf16 ? msa_pool_fwd_kernel<decltype(fixed)::value, true>
           : msa_pool_fwd_kernel<decltype(fixed)::value, false>)
        <<<(N + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
            lgpart, parts, static_cast<const unsigned char*>(mask), qkv, h3,
            kBf16 ? wg::ld8(D) : 3 * D, out, N, L, D);
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
