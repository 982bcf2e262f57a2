// Matrix products on Hopper's warpgroup tensor-core instruction (wgmma),
// fed by the Tensor Memory Accelerator (TMA), for sm_90a: the products of
// the bf16 instances of kernels A and A' (msa_encoder.cu,
// msa_encoder_pooled_bf16; msa_encoder_bwd.cu, msa_encoder_bwd_bf16) and of
// kernel B's two bf16 instances (gat_layer.cu: gat_layer_project_bf16_act,
// A's q|k|v instance; gat_layer_project_bf16, x's three planes against the
// bf16 weights). They replace no TPU kernel of their own: they are A's,
// A''s and B's products, which the TPU kernels
// (digat_tpu/ops/pallas/msa_encoder.py, _fwd_kernel and _bwd_kernel;
// digat_tpu/ops/pallas/gat_layer.py, _layer_kernel) run on their matrix
// unit.
//
// C[z] = op(A)[M, K_z] op(B)[K_z, N] over the z-th slice of K, then one of
// tc_gemm.cuh's epilogues (kStore, kBias, kPool, kDh, kDrop, kLogits: the
// same arithmetic, four outputs at a time), with the same Args. Every operand is
// bf16 in device memory, as `terms` planes: a bf16 matrix is one plane,
// exact; an fp32 matrix x is three, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), which sum back to x within 2^-24 |x| (written by the
// kernel that produces x, or by split3_kernel below;
// tests/test_torch_bf16_split.py replays the split and the products on the
// CPU). A product of a three-term operand with an exact one takes three
// passes, lo, mid, hi (each partial product exact in fp32); of two
// three-term operands six, every pair down to 2^-16 of the leading term
// (mid mid, lo hi, hi lo, mid hi, hi mid, hi hi): the dropped pairs are at
// 2^-24 and below, as 3xTF32 drops lo lo. The passes run small terms first.
//
// Layout. An operand is "K-major" when its rows run along K (A[m][k], a
// weight B[n][k]) and "MN-major" when K runs down its rows (A[k][m],
// B[k][n]); bf16 wgmma reads both from shared memory (the transpose bits of
// the instruction), so the weight gradients, whose K is the N L rows of
// both operands, need no transposing pass. The TMA copies 128-byte-wide
// boxes with the 128-byte swizzle that the wgmma descriptors name: a
// K-major tile is rows of 64 k (KT 64), an MN-major tile is KT rows of k
// of 64 m or n, boxes side by side for wider tiles. Rows must sit 16 bytes
// apart at least (ld % 8 == 0): the caller pads the operands it writes.
// The TMA fills rows and columns past the matrix with zeros, so a partial
// tile needs no masking but in the epilogue.
//
// Block: three warpgroups, a block a tile. One thread of the third issues
// the TMA copies of each k-tile into a ring of kStages shared-memory stages
// (three or four; each holds every plane of the A and B tiles) and waits
// on the stage's `empty` mbarrier before refilling it; the copies complete
// on its `full` mbarrier. The first two warpgroups (consumers) each own 64
// rows of the block's 128 x BN outputs (kSN: 64 rows, BN columns each, side
// by side): they wait on `full`, issue the tile's chain of wgmma.mma_async
// (every pass and every 16-deep step), wait for it, free the stage, and add
// the chain's sums to their running sums (kRN, below). setmaxnreg gives the
// producer 40 registers and each consumer 232. An fp32 C is staged in the
// freed ring and leaves by one TMA store per consumer.
//
// What bounds it on an H100: not the tensor cores. At A''s shapes the
// products took as long with no wgmma issued as with them (PERF.md): the
// ring fills at about 3.5 TB/s over the card (each stage holds 48-67 KB for
// 6-8 MFLOP), and the epilogues' traffic adds to it. The tiles are as
// large as kRN's two sets of accumulators let the registers hold (64 x 152
// a consumer), and the TMA maps ask L2 for 128-byte lines (256 bytes cost
// 7 %). Sending A's tile to a cluster of CTAs by TMA multicast ran slower.
//
// Rounding of the sums (kRN, as tc_gemm.cuh). The tensor cores add each
// product into the fp32 accumulator rounding toward zero. So each k-tile's
// chain starts from fresh registers (the first wgmma of a chain does not
// read D) and its sums are added to the running sums on the CUDA cores,
// rounding to nearest: 64 (or 32) deep, 3 or 6 passes, before each
// rounding to nearest.
//
// Determinism: a slice of K is a fixed run of k-tiles summed in order, and
// the caller sums the slices' partials in slice order (no atomics): the
// same bits on every run.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_gemm.cuh"

namespace digat {
namespace wg {

constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer's
constexpr int kBM = 64 * kConsumers;              // rows of a tile split by rows
constexpr int kSmemLimit = 227 * 1024;            // opt-in shared memory of a block
constexpr int kMaxStages = 4;
// A consumer's tile widths of kernels A's and A''s products: 128 (A's pool
// logits, A''s u and weight gradients) and 152 (q|k|v, dO and dx: eight and
// three tiles of 152 over 3D 1,200 and D 400). A's q|k|v and A''s
// recompute of it are one instance, so the two are the same bits.
constexpr int kN = 128, kNx = 152;

// One operand in device memory: `terms` bf16 planes of [rows][ld] (ld >= cols,
// ld % 8 == 0), `plane` elements apart (the same as rows * ld for one term).
struct Operand {
  const __nv_bfloat16* p;
  int rows, cols, ld;
  long long plane;
};

// The (A term, B term) of pass q of a TA x TB product, small terms first.
__host__ __device__ constexpr int pass_a(int TA, int TB, int q) {
  return TA == 3 && TB == 3 ? (q == 0 ? 1 : q == 1 ? 2 : q == 3 ? 1 : 0) : TA == 3 ? 2 - q : 0;
}
__host__ __device__ constexpr int pass_b(int TA, int TB, int q) {
  return TA == 3 && TB == 3 ? (q == 0 ? 1 : q == 2 ? 2 : q == 4 ? 1 : 0) : TB == 3 ? 2 - q : 0;
}
__host__ __device__ constexpr int passes(int TA, int TB) {
  return TA == 3 && TB == 3 ? 6 : TA * TB;
}

// Shape and shared memory of one instance. The two consumers split the
// block's tile by rows (128 x BN, each 64 x BN) or, with kSN, by columns
// (64 x 2 BN, each 64 x BN: the block reads its A rows once for 2 BN
// columns). kStages stages of TA A tiles and TB B tiles (a B tile of kSN
// is two sub-tiles of BN columns).
template <int BN, int KT, bool BK, int TA, int TB, bool kSN>
struct Geometry {
  static constexpr int kRows = kSN ? 64 : kBM;                 // rows of a block's tile
  static constexpr int kParts = kSN ? kConsumers : 1;          // B sub-tiles
  static constexpr int kCols = kParts * BN;                    // columns of a block's tile
  static constexpr int kBSub = BK ? BN : (BN + 63) / 64 * 64;  // MN-major: whole boxes
  static constexpr int kATile = kRows * KT * 2;                // bytes of one plane's tile
  static constexpr int kBSubBytes = kBSub * KT * 2;
  static constexpr int kBTile = kParts * kBSubBytes;
  static constexpr int kStage = TA * kATile + TB * kBTile;
  static constexpr int kStages0 = (kSmemLimit - 1024 - 256) / kStage;
  static constexpr int kStages = kStages0 < kMaxStages ? kStages0 : kMaxStages;
  static constexpr int kBytes = kStages * kStage + 1024 + 256;  // + alignment, barriers
  static_assert(kStages >= 3, "a ring of three stages at least");
  static_assert(kATile % 1024 == 0 && kBSubBytes % 1024 == 0, "swizzle atoms 1024-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` of the barrier has completed. A wait
// that outlasts 2^24 polls (a pipeline fault, not a slow copy) traps, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 24)) asm volatile("trap;");
  } while (!done);
}

// A box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving register accesses across the asynchronous
// products that read and write them
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D = A B (+ D where scale_d != 0), m64n128k16, bf16 operands from shared memory
template <int kTA, int kTB>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// D = A B (+ D where scale_d != 0), m64n152k16, bf16 operands from shared memory
template <int kTA, int kTB>
__device__ __forceinline__ void mma_n152(float (&d)[76], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
      "}, %76, %77, p, 1, 1, %79, %80;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}


template <int BN, int kTA, int kTB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(BN == 128 || BN == 152, "tile widths with a wgmma wrapper");
  if constexpr (BN == 128) mma_n128<kTA, kTB>(d, a, b, scale_d);
  else mma_n152<kTA, kTB>(d, a, b, scale_d);
}

// The epilogue's arithmetic on four consecutive outputs (row, col .. col +
// 3), col a multiple of 4, from their sums `v` (tc_gemm.cuh's epilogue, four
// at a time: 16-byte loads, kDrop the four draws of one Philox block);
// kPool and kLogits add their v-product to `lg`; kDh takes h from the caller.
template <int EPI>
__device__ __forceinline__ float4 quad_value(const tc::Args& p, int row, int col, int tt, int pos,
                                             float4 v, float4 h, float& lg) {
  if (EPI == tc::kBias) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + col));
    v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  } else if (EPI == tc::kPool || EPI == tc::kLogits) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + col));
    const float4 u = __ldg(reinterpret_cast<const float4*>(p.v + col));
    v = make_float4(tanhf(v.x + b.x), tanhf(v.y + b.y), tanhf(v.z + b.z), tanhf(v.w + b.w));
    lg = fmaf(v.x, u.x, lg);
    lg = fmaf(v.y, u.y, lg);
    lg = fmaf(v.z, u.z, lg);
    lg = fmaf(v.w, u.w, lg);
  } else if (EPI == tc::kDh) {
    const float a = __ldg(p.alpha + row);
    const float4 d = __ldg(reinterpret_cast<const float4*>(p.dp + (size_t)tt * p.N + col));
    v = make_float4(h.x > 0.f ? fmaf(a, d.x, v.x) : 0.f, h.y > 0.f ? fmaf(a, d.y, v.y) : 0.f,
                    h.z > 0.f ? fmaf(a, d.z, v.z) : 0.f, h.w > 0.f ? fmaf(a, d.w, v.w) : 0.f);
  } else if (EPI == tc::kDrop) {
    const int flat = pos * p.N + col;  // col and N multiples of 4: one group
    v = dropout_value4(v, dropout_draws(uint32_t(tt), uint32_t(flat >> 2), p.seed, p.site),
                       p.thresh, p.drop_scale);
  }
  return v;
}

// The same on two outputs (row, col), (row, col + 1), col even.
template <int EPI>
__device__ __forceinline__ float2 pair_value(const tc::Args& p, int row, int col, int tt, int pos,
                                             float2 v, float2 h, float& lg) {
  if (EPI == tc::kBias) {
    v.x += __ldg(p.bias + col);
    v.y += __ldg(p.bias + col + 1);
  } else if (EPI == tc::kPool || EPI == tc::kLogits) {
    v.x = tanhf(v.x + __ldg(p.bias + col));
    v.y = tanhf(v.y + __ldg(p.bias + col + 1));
    lg = fmaf(v.x, __ldg(p.v + col), lg);
    lg = fmaf(v.y, __ldg(p.v + col + 1), lg);
  } else if (EPI == tc::kDh) {
    const float a = __ldg(p.alpha + row);
    const float2 d = __ldg(reinterpret_cast<const float2*>(p.dp + (size_t)tt * p.N + col));
    v.x = h.x > 0.f ? fmaf(a, d.x, v.x) : 0.f;
    v.y = h.y > 0.f ? fmaf(a, d.y, v.y) : 0.f;
  } else if (EPI == tc::kDrop) {
    const int flat = pos * p.N + col;  // col even, N % 4 == 0: one group
    const Philox4 d = dropout_draws(uint32_t(tt), uint32_t(flat >> 2), p.seed, p.site);
    v.x = dropout_value(v.x, (flat & 3) ? d.z : d.x, p.thresh, p.drop_scale);
    v.y = dropout_value(v.y, (flat & 3) ? d.w : d.y, p.thresh, p.drop_scale);
  }
  return v;
}

// named barrier `kId` (0 is __syncthreads') among `kThreads` threads
template <int kId, int kCount>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

// A consumer's 64 x BN outputs from row m0 and column n0: its warp `w` holds
// rows 16 w + g and 16 w + g + 8 and, of each 8 columns j, columns
// 2t and 2t + 1 (registers 4 j .. 4 j + 3), as mma.sync's C fragments.
// Lanes t and t ^ 1 swap halves of two neighbouring 8-column groups, so
// each lane holds four consecutive columns (quad_value); an odd last group
// goes by pairs. The tile's slice z of K writes C's z-th partial; kPool's
// and kLogits' v-product takes one part per column block (lgpart[part][row]),
// each part summed over the consumer's columns in the same order; kLogits
// writes no C. An fp32 C
// goes through shared memory (`stage`, 64 x BN) and one TMA store of the
// consumer's rows (`mo`), which clips rows and columns past C; a bf16 C is
// stored from registers. kDh first copies the consumer's rows of h into the
// stage (`mh`, completing on `hbar`): each thread reads h there before it
// writes its outputs over it.
template <int BN, int EPI, typename TC>
__device__ __forceinline__ void epilogue(const tc::Args& p, const float (&acc)[BN / 2], int m0,
                                         int n0, int z, int part, const CUtensorMap* mo,
                                         const CUtensorMap* mh, uint32_t hbar, float* stage) {
  constexpr int kGroups = BN / 8;
  constexpr bool kLg = EPI == tc::kPool || EPI == tc::kLogits;
  constexpr bool kStaged = std::is_same<TC, float>::value && EPI != tc::kLogits;
  constexpr bool kStored = EPI != tc::kLogits;
  static_assert(EPI != tc::kDh || kStaged, "kDh stages h");
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  if (EPI == tc::kDh) {  // the consumer's rows of h into the stage, by one TMA copy
    if ((threadIdx.x & 127) == 0) {
      mbar_expect_tx(hbar, 64 * BN * 4);
      tma_load(smem_u32(stage), mh, hbar, n0, m0, 0);
    }
    mbar_wait(hbar, 0);
  }
  TC* C = static_cast<TC*>(p.C) + (size_t)z * p.M * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w * 16 + g + half * 8, row = m0 + r;
    const bool row_in = row < p.M;
    int tt = 0, pos = 0;
    if (EPI == tc::kDh || EPI == tc::kDrop) tc::title_row(row, p.title, tt, pos);
    float lg = 0.f;
#pragma unroll
    for (int j = 0; j + 1 < kGroups; j += 2) {
      const float a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
      const float b0 = acc[4 * j + 4 + 2 * half], b1 = acc[4 * j + 4 + 2 * half + 1];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const int c = 8 * j + (odd ? 8 + 2 * (t - 1) : 2 * t), col = n0 + c;
      const bool in = row_in && col < p.N;  // N is a multiple of 4: col + 3 < N too
      float4 v = odd ? make_float4(r0, r1, b0, b1) : make_float4(a0, a1, r0, r1);
      const float4 h = EPI == tc::kDh ? *reinterpret_cast<const float4*>(stage + r * BN + c)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) v = quad_value<EPI>(p, row, col, tt, pos, v, h, lg);
      if (kStaged) *reinterpret_cast<float4*>(stage + r * BN + c) = v;
      else if (kStored && in) digat::store4(C + (size_t)row * p.ldc + col, v);
    }
    if (kGroups % 2) {
      const int j = kGroups - 1, c = 8 * j + 2 * t, col = n0 + c;
      const bool in = row_in && col < p.N;
      float2 v = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      const float2 h = EPI == tc::kDh ? *reinterpret_cast<const float2*>(stage + r * BN + c)
                                      : make_float2(0.f, 0.f);
      if (in) v = pair_value<EPI>(p, row, col, tt, pos, v, h, lg);
      if (kStaged) *reinterpret_cast<float2*>(stage + r * BN + c) = v;
      else if (kStored && in) digat::store2(C + (size_t)row * p.ldc + col, v);
    }
    if (kLg) {
      lg += __shfl_xor_sync(0xffffffffu, lg, 1);
      lg += __shfl_xor_sync(0xffffffffu, lg, 2);
      if (t == 0 && row_in) p.lgpart[(size_t)part * p.M + row] = lg;
    }
  }
  if (kStaged) {  // the staged rows to C by one TMA store of the consumer's
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (threadIdx.x >> 7) bar_sync<3, 128>();
    else bar_sync<2, 128>();
    if ((threadIdx.x & 127) == 0) {
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
              reinterpret_cast<uint64_t>(mo)),
          "r"(smem_u32(stage)), "r"(n0), "r"(m0), "r"(z)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // stage read: may end
    }
  }
}

// The tiles of a launch, n fastest (the blocks at work share A's rows in
// L2), then m, then the slice of K.
struct Tiles {
  int n, m, z;
};

// AK / BK: A / B K-major; TA / TB: their terms (1 or 3); KT: the k-tile's
// depth (64; 32 where both operands are MN-major). A block a tile, the
// grid one-dimensional over Tiles. (Persistent blocks walking the tiles in
// a fixed order ran 1-30 % slower at A''s shapes: the hardware's own
// dispatch balances the SMs better.)
template <int BN, int KT, bool AK, bool BK, int TA, int TB, int EPI, typename TC, bool kSN>
__global__ void __launch_bounds__(kThreads, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mo, const __grid_constant__ CUtensorMap mh,
               tc::Args p, Tiles tiles) {
  using G = Geometry<BN, KT, BK, TA, TB, kSN>;
  static_assert(KT == 64 || (KT == 32 && !AK && !BK), "K-major tiles are 64 deep");
  static_assert(BK || BN % 64 == 0, "an MN-major B tile is whole 64-wide boxes");
  constexpr int kPasses = passes(TA, TB);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's atoms are 1024-byte aligned
  const uint32_t full = base + G::kStages * G::kStage, empty = full + 8 * G::kStages;
  const uint32_t hbar = empty + 8 * G::kStages;  // kDh: a consumer's h copy
  const int grp = threadIdx.x >> 7;
  // the block's tile: its column block, row block and slice of K
  const int nb = blockIdx.x % tiles.n, z = blockIdx.x / (tiles.n * tiles.m);
  const int m0 = (blockIdx.x / tiles.n) % tiles.m * G::kRows, n0 = nb * G::kCols;
  const int kbeg = z * p.k_per_split;
  const int kts = (min(p.K, kbeg + p.k_per_split) - kbeg + KT - 1) / KT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // a warp of each consumer's
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(hbar + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (grp == kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < kts; ++kt) {
        const int s = kt % G::kStages;
        if (kt >= G::kStages) mbar_wait(empty + 8 * s, (kt / G::kStages - 1) & 1);
        const uint32_t bar = full + 8 * s, st = base + s * G::kStage;
        mbar_expect_tx(bar, G::kStage);
        const int k = kbeg + kt * KT;
#pragma unroll
        for (int q = 0; q < TA; ++q) {
          if (AK) {
            tma_load(st + q * G::kATile, &ma, bar, k, m0, q);
          } else {
#pragma unroll
            for (int j = 0; j < G::kRows / 64; ++j)
              tma_load(st + q * G::kATile + j * 128 * KT, &ma, bar, m0 + 64 * j, k, q);
          }
        }
#pragma unroll
        for (int q = 0; q < TB; ++q) {
#pragma unroll
          for (int h = 0; h < G::kParts; ++h) {
            const uint32_t bt = st + TA * G::kATile + q * G::kBTile + h * G::kBSubBytes;
            if (BK) {
              tma_load(bt, &mb, bar, k, n0 + h * BN, q);
            } else {
#pragma unroll
              for (int j = 0; j < G::kBSub / 64; ++j)
                tma_load(bt + j * 128 * KT, &mb, bar, n0 + h * BN + 64 * j, k, q);
            }
          }
        }
      }
    }
  } else {  // a consumer: rows 64 grp .. 64 grp + 63 of the tile (kSN: columns BN grp ..)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    // descriptors (CUTLASS's canonical GMMA layouts, B128): a K-major tile
    // steps 32 bytes a 16-deep step inside its 128-byte rows (the swizzle
    // applies to the address), 8-row groups 1024 bytes apart (SBO), LBO 16
    // bytes; an MN-major tile steps 16 rows of 128 bytes, 8-row groups of k
    // 1024 bytes apart (SBO), 64-wide boxes 128 KT bytes apart (LBO)
    const uint32_t a_rows = kSN ? 0 : AK ? grp * 64 * 128 : grp * 128 * KT;
    const uint32_t b_sub = kSN ? grp * G::kBSubBytes : 0;
    for (int kt = 0; kt < kts; ++kt) {
      const int s = kt % G::kStages;
      mbar_wait(full + 8 * s, (kt / G::kStages) & 1);
      const uint32_t st = base + s * G::kStage;
      pin(part);
      mma_fence();
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const uint32_t at = st + pass_a(TA, TB, q) * G::kATile + a_rows;
        const uint32_t bt = st + TA * G::kATile + pass_b(TA, TB, q) * G::kBTile + b_sub;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          const uint64_t da = desc(at + kk * (AK ? 32 : 2048), AK ? 16 : 128 * KT, 1024);
          const uint64_t db = desc(bt + kk * (BK ? 32 : 2048), BK ? 16 : 128 * KT, 1024);
          mma<BN, AK ? 0 : 1, BK ? 0 : 1>(part, da, db, (q | kk) != 0);
        }
      }
      mma_commit();
      mma_wait();
      pin(part);
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    // the ring is free once both consumers are done with it: each stages
    // its outputs there
    bar_sync<1, 128 * kConsumers>();
    uint8_t* ring = smem_raw + (base - raw);
    epilogue<BN, EPI, TC>(p, acc, m0 + (kSN ? 0 : grp * 64), n0 + (kSN ? grp * BN : 0), z,
                          nb * G::kParts + (kSN ? grp : 0), &mo, &mh, hbar + 8 * grp,
                          reinterpret_cast<float*>(ring) + grp * 64 * BN);
  }
}

// ---------------------------------------------------------------------------
// The operands' bf16 copies and planes: rows ld8(cols) elements apart (16
// bytes at least, as the TMA takes them)
// ---------------------------------------------------------------------------
constexpr int kCopyThreads = 256;  // a block of the copy kernels below

// bf16 elements of a row of a plane
__host__ __device__ inline int ld8(int cols) { return (cols + 7) & ~7; }

// blocks of kCopyThreads for `work` threads
inline unsigned copy_blocks(long long work) {
  return unsigned((work + kCopyThreads - 1) / kCopyThreads);
}

// x as three bf16 terms: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
// - mid), each difference exact in fp32 (the three-term operand above)
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  const float rest = x - __bfloat162float(__float2bfloat16_rn(x));
  hi = x - rest;
  mid = __bfloat162float(__float2bfloat16_rn(rest));
  lo = rest - mid;
}

// element i of the three planes `plane` apart (lo rounded to bf16 here)
__device__ __forceinline__ void store3(__nv_bfloat16* p, size_t plane, float x) {
  float hi, mid, lo;
  split3(x, hi, mid, lo);
  p[0] = __float2bfloat16_rn(hi);
  p[plane] = __float2bfloat16_rn(mid);
  p[2 * plane] = __float2bfloat16_rn(lo);
}

// four consecutive elements (8-byte aligned) of the three planes
__device__ __forceinline__ void store3x4(__nv_bfloat16* p, size_t plane, float4 z) {
  float h[4], m[4], l[4];
  split3(z.x, h[0], m[0], l[0]);
  split3(z.y, h[1], m[1], l[1]);
  split3(z.z, h[2], m[2], l[2]);
  split3(z.w, h[3], m[3], l[3]);
  digat::store4(p, make_float4(h[0], h[1], h[2], h[3]));
  digat::store4(p + plane, make_float4(m[0], m[1], m[2], m[3]));
  digat::store4(p + 2 * plane, make_float4(l[0], l[1], l[2], l[3]));
}

namespace {  // each source that includes this header gets its own kernels

// The three bf16 planes of an fp32 x [rows][cols] (row stride ldx; cols a
// multiple of 4), rows ld8(cols) apart, planes rows * ld8(cols) apart. A
// thread a group of four (rows * cols / 4 < 2^31).
__global__ void __launch_bounds__(kCopyThreads)
split3_kernel(const float* __restrict__ x, int ldx, __nv_bfloat16* __restrict__ out, int rows,
              int cols) {
  const uint32_t c4 = cols / 4, i = blockIdx.x * kCopyThreads + threadIdx.x;
  if (i >= uint32_t(rows) * c4) return;
  const uint32_t r = i / c4, c = (i - r * c4) * 4;
  const size_t ld = ld8(cols), plane = size_t(rows) * ld;
  store3x4(out + r * ld + c, plane, digat::load4(x + size_t(r) * ldx + c));
}

// dst [rows][ld8(cols)] = src [rows][cols] (row stride lds; kTranspose:
// src [cols][rows]), bf16: the K-major weight copies and x's 16-byte rows.
// A thread an element (kTranspose) or a group of four (rows * cols < 2^31).
template <bool kTranspose>
__global__ void __launch_bounds__(kCopyThreads)
relayout_kernel(const __nv_bfloat16* __restrict__ src, int lds, int rows, int cols,
                __nv_bfloat16* __restrict__ dst) {
  const uint32_t per = kTranspose ? cols : cols / 4, i = blockIdx.x * kCopyThreads + threadIdx.x;
  if (i >= uint32_t(rows) * per) return;
  const uint32_t r = i / per, c = i - r * per;
  const size_t ld = ld8(cols);
  if (kTranspose) {
    dst[r * ld + c] = src[size_t(c) * lds + r];
  } else {  // cols and lds multiples of 4: 8-byte groups
    *reinterpret_cast<uint2*>(dst + r * ld + 4 * c) =
        __ldg(reinterpret_cast<const uint2*>(src + size_t(r) * lds + 4 * c));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Host side: tensor maps through libcuda's cuTensorMapEncodeTiled, reached
// with cudaGetDriverEntryPoint (no link against libcuda), and the launch.
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled& encode_tiled() {
  static EncodeTiled fn = nullptr;
  return fn;
}

// Looks libcuda's encoder up once (the kernel's init).
inline cudaError_t init_encoder() {
  if (encode_tiled()) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                          &found);
#endif
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
  encode_tiled() = reinterpret_cast<EncodeTiled>(fn);
  return cudaSuccess;
}

// The 3-d map (cols, rows, terms) of an operand, boxes of 64 columns x
// `box_rows` rows x 1 plane, 128-byte swizzle, zeros past the matrix.
inline bool make_map(CUtensorMap* map, const Operand& o, int terms, int box_rows) {
  if (!encode_tiled() || o.ld % 8 || o.plane % 8 || o.cols > o.ld ||
      reinterpret_cast<uintptr_t>(o.p) % 16)
    return false;
  const cuuint64_t dims[3] = {cuuint64_t(o.cols), cuuint64_t(o.rows), cuuint64_t(terms)};
  const cuuint64_t strides[2] = {cuuint64_t(o.ld) * 2, cuuint64_t(o.plane) * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<__nv_bfloat16*>(o.p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3-d map (cols, rows, slices) of an fp32 C [slices][rows][ld], boxes
// of `box_cols` x 64 rows, no swizzle: the epilogue's TMA store (and kDh's
// copy of h).
inline bool make_out_map(CUtensorMap* map, const void* c, int cols, int rows, int slices, int ld,
                         int box_cols) {
  if (!encode_tiled() || ld % 4 || reinterpret_cast<uintptr_t>(c) % 16) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(slices)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 4, cuuint64_t(ld) * 4 * rows};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(c), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Grants the kernel its shared memory on the current device.
template <int BN, int KT, bool AK, bool BK, int TA, int TB, int EPI, typename TC = float,
          bool kSN = false>
inline cudaError_t init() {
  cudaError_t e = init_encoder();
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(wg_gemm_kernel<BN, KT, AK, BK, TA, TB, EPI, TC, kSN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Geometry<BN, KT, BK, TA, TB, kSN>::kBytes);
}

// Launches wg_gemm_kernel on `st`, a block a tile, for p's M, N, K, ldc,
// k_per_split (a multiple of KT unless one slice takes all of K) and
// epilogue fields, A and B as given (A: [M][K] K-major, else [K][M]; B:
// [N][K] K-major, else [K][N]); p.A and p.B are not read. kPool's and
// kLogits' parts: ceil(N / BN) (kSN: two a column block of 2 BN).
template <int BN, int KT, bool AK, bool BK, int TA, int TB, int EPI, typename TC = float,
          bool kSN = false>
inline cudaError_t gemm(cudaStream_t st, const Operand& a, const Operand& b, const tc::Args& p) {
  using G = Geometry<BN, KT, BK, TA, TB, kSN>;
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.k_per_split <= 0 || p.N % 4 ||
      (p.k_per_split % KT && p.k_per_split < p.K) ||
      (AK ? a.rows != p.M || a.cols != p.K : a.rows != p.K || a.cols != p.M) ||
      (BK ? b.rows != p.N || b.cols != p.K : b.rows != p.K || b.cols != p.N))
    return cudaErrorInvalidValue;
  const Tiles tiles{(p.N + G::kCols - 1) / G::kCols, (p.M + G::kRows - 1) / G::kRows,
                    (p.K + p.k_per_split - 1) / p.k_per_split};
  const long long count = (long long)tiles.n * tiles.m * tiles.z;
  if (count >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mo = {}, mh = {};
  if (!make_map(&ma, a, TA, AK ? G::kRows : KT) || !make_map(&mb, b, TB, BK ? BN : KT) ||
      (std::is_same<TC, float>::value && EPI != tc::kLogits &&
       (p.ldc != p.N || !make_out_map(&mo, p.C, p.N, p.M, tiles.z, p.ldc, BN))) ||
      (EPI == tc::kDh && !make_out_map(&mh, p.h, p.N, p.M, 1, p.ldc, BN)))
    return cudaErrorInvalidValue;
  wg_gemm_kernel<BN, KT, AK, BK, TA, TB, EPI, TC, kSN>
      <<<unsigned(count), kThreads, G::kBytes, st>>>(ma, mb, mo, mh, p, tiles);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace digat
