// The masked attention pair's wide instance: heads of dk 65 to 128, forward
// and backward, fp32 and bf16 (q, k, v, do and the outputs of element type
// T; the rows held and every sum run in fp32; each output rounded once to
// T), on the tensor cores. A file of its own, so that nvcc compiles it
// beside the register-row instances (msa_attention_kernels.cuh), in parallel.
//
// Replaces digat_tpu/ops/pallas/msa_attention.py::_fwd_kernel (:51) and
// _bwd_kernel (:75) at heads of dk 65 to 128 (`pallas_call` at :141 and
// :177): per sequence n and head h, on the packed [N, L, H hs] layout (heads
// hs lanes apart, the first dk read; the E layout's pad lanes [dk, hs) of
// out, dq, dk and dv written as zeros),
//
//     s = where(keep, q k^T * scale, -1e9),  out = softmax(s) v,
//
// and its VJP as msa_attention_kernels.cuh's header note states it.
//
// What bounds it on an H100. Per (query, key) pair of a head the forward
// does 4 dk FLOP, the backward 10 dk, against 16 dk (28 dk) bytes a row of
// q, k, v and out (and do, dq, dk, dv) at fp32: at L 160 the forward needs
// 40 FLOP a byte, past the 20 at which fp32 on the CUDA cores (67 TFLOP/s)
// would take over from HBM (3.35 TB/s). So the products go to the tensor
// cores, and the kernel has to keep them fed: the simple kernel this
// replaces ran one warp a block (a row a lane, k and v of the whole head in
// shared memory, under 10 % of its bound) on scalar FMAs read from shared
// memory, and formed each score twice in the forward and about nine times
// in the backward.
//
// Design.
//  * Blocks of 4 warps; a warp owns 16 rows (one m16 tile): query rows in
//    the forward and in the backward's row passes, key rows in its column
//    pass. Beyond L 32 a block owns 64 rows of one (sequence, head) unit;
//    at L 17-32 two units (2 warps each), at L <= 16 four (a warp each), so
//    that a block still runs 4 warps (`wide_geom`).
//  * The block's own rows sit in shared memory in the operands' type (fp32
//    rows kKS = 132 floats apart, bf16 rows kKSB = 136 apart); the other
//    side's rows stream through in tiles (16 fp32 rows, 32 bf16: `Rows`),
//    double-buffered by cp.async (16 bytes of fp32, 8 of bf16, zero-filled
//    past dk) issued for tile t + 1 before tile t's products. No stage
//    holds more than a tile, so L is not capped by shared memory (the
//    simple kernel held k and v whole and took L up to 203 forward, 185
//    backward). A warp whose 16 rows all lie past L loads and waits with
//    its block but forms no product.
//  * Products on the tensor cores (mma.sync), fp32 accumulators.
//    fp32: m16n8k8 TF32; an operand x is split as it is read from shared
//    memory into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a product
//    is summed as lo*hi + hi*lo + hi*hi (3xTF32, as tc_gemm.cuh; one TF32
//    pass misses the fp32 gate of 1e-4).
//    bf16: m16n8k16 bf16. q k^T and do v^T take their bf16 operands as they
//    are (one pass, the products exact in fp32); p v and the gradient
//    products take the fp32 probabilities (or ds) as a bf16 hi and lo
//    (x - hi rounded again: x to about 2^-17) against the bf16 rows, two
//    passes, where TF32 would take four of half the depth.
//    Each 32-column k-tile of a score and each streamed tile of an output
//    row is summed in fresh registers and added rounding to nearest (kRN,
//    as A, A' and B: the tensor cores' own adds truncate).
//  * The scores' C fragment (lane: rows g, g + 8, keys 2t, 2t + 1 of an
//    8-key tile) is the next product's A operand without a shuffle. bf16:
//    an m16n8k16 A fragment holds those pairs as they stand. TF32 (rows g,
//    g + 8, columns t, t + 4): the 8 keys are taken in the order 2t -> t,
//    2t + 1 -> t + 4, and the value tile's B fragment reads rows 2t and
//    2t + 1 to match (a sum over the keys does not depend on their order).
//    The row strides put every fragment pattern on 32 banks.
//  * Forward: each score once per (query tile, key tile); the online softmax
//    in registers, the row max and sum over a quad by shuffles; out = o / l.
//  * Backward: three launches, no atomics, every element summed by one lane
//    in a fixed order, so the same bits come out on every run. The forward
//    saves nothing (the entry points keep their signatures), so the row
//    statistics are recomputed, as JAX's F recomputes them:
//      1. rows pass, statistics: per query tile over the key tiles, s and
//         dp = do v^T, the row max m, 1 / sum and t = sum_j p dp online;
//         written into the row's first lanes of dq (3 floats; 6 bf16 slots
//         as bits), which the last pass overwrites;
//      2. column pass: per key tile over the query tiles, s^T, dp^T, p =
//         exp(s - m) / sum, ds = keep ? p (dp - t) scale : 0, dv += p^T do
//         and dk += ds^T q;
//      3. rows pass, dq: s, dp, ds again, dq += ds k.
//    s and dp are formed three times a pair, the products 9 times in all
//    (the simple kernel formed some 18 dot products of dk a pair).
//  * dk is padded to kPad = 16 columns with zeros (not to 128: at dk 80 that
//    would waste 37.5 % of the products); a key past L scores -inf (counts
//    exactly 0), a masked key -1e9 (an all-masked row averages v) and passes
//    no gradient (ds 0).
// ops/msa_attention.py's `block_shape` and `_smem_bytes` state the same
// geometry; chip_smoke.py prints ptxas's registers and spills of each
// instantiation.

#include "msa_attention.cuh"

namespace {

constexpr int kWarps = 4;              // warps of a block
constexpr int kKS = kv_stride(kWide);  // floats between two fp32 shared rows (132)
constexpr int kKSB = kWide + 8;        // elements between two bf16 shared rows (136)
constexpr int kNT = kWide / 8;         // 8-column tiles of a row
constexpr int kPad = 16;               // dk is padded to a multiple of kPad

// Geometry (as ops/msa_attention.py's `_wide_geometry`): wpu warps a unit,
// upb units a block, ot = 16 wpu own rows a unit and block, tpu blocks'
// worth of own rows a unit.
struct WideGeom {
  int wpu, upb, ot, tpu;
};

__host__ __device__ inline WideGeom wide_geom(int L) {
  WideGeom w;
  w.wpu = L <= 16 ? 1 : (L <= 32 ? 2 : 4);
  w.upb = kWarps / w.wpu;
  w.ot = 16 * w.wpu;
  w.tpu = (L + w.ot - 1) / w.ot;
  return w;
}

enum WideKind : int { kFwd = 0, kRows = 1, kCols = 2 };

// Shared rows hold the operands' elements (fp32, or bf16 as loaded), KS
// elements apart; a streamed tile is KT rows: 16 fp32 (two stages of k and
// v fill 67.6 KB), 32 bf16 (69.6 KB).
__host__ __device__ constexpr int tile_rows(int esize) { return esize == 4 ? 16 : 32; }

template <typename T>
struct Rows {
  static constexpr int KS = sizeof(T) == 4 ? kKS : kKSB;
  static constexpr int KT = tile_rows(sizeof(T));
};

// bytes of one unit's shared memory, rows of `esize`-byte elements: its
// own rows (q; q and do; k and v), the column pass's statistics of the
// streamed rows (2 stages of m, 1 / sum, t as floats) and its own keys'
// mask bytes, or the row passes' streamed keys' mask bytes (2 stages),
// then the streamed tiles (one stage where one tile holds L); every part a
// multiple of 16 bytes
__host__ __device__ inline size_t wide_unit_bytes(int kind, int L, int esize) {
  const WideGeom w = wide_geom(L);
  const size_t row = size_t(esize == 4 ? kKS : kKSB) * esize;
  const size_t own = size_t(kind == kFwd ? 1 : 2) * w.ot * row;
  const int KT = tile_rows(esize);
  const size_t small = kind == kCols ? 2 * 3 * KT * sizeof(float) + w.ot : 2 * KT;
  return own + small + size_t(L > KT ? 2 : 1) * 2 * KT * row;
}

__host__ __device__ inline size_t wide_block_bytes(int kind, int L, int esize) {
  return wide_geom(L).upb * wide_unit_bytes(kind, L, esize);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 8 bytes (4 bf16), zero-filled past `bytes`
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as a TF32 hi and lo
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at 3xTF32 (lo*hi, hi*lo, hi*hi)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma8(d, al, bh[0], bh[1]);
  mma8(d, ah, bl[0], bl[1]);
  mma8(d, ah, bh[0], bh[1]);
}

// d += a b, bf16 operands (pairs of a row's columns), fp32 sums
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments by ldmatrix: four 8 x 8 matrices of 16-bit elements (an 8 x 4
// block of fp32 words, or 8 x 8 bf16) a call, lane i giving the address of
// row i % 8 of matrix i / 8, which lane 4g + t receives as row g's word t
// (with .trans, the column pairs). Rows 528 (fp32) or 272 (bf16) bytes
// apart put a matrix's 8 rows on 8 distinct bank groups.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// A fragment of 16 shared rows at A, columns 8 ks .. 8 ks + 7
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* A,
                                       int ks, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldsm4(x, A + (r + 8 * (m & 1)) * kKS + 8 * ks + 4 * (m >> 1));
#pragma unroll
  for (int c = 0; c < 4; ++c) split(__uint_as_float(x[c]), hi[c], lo[c]);
}

// B fragments of k-steps ks and ks + 1, B[k][n] = Y[8 nt + n][8 ks + k]:
// rows of Y as columns
__device__ __forceinline__ void frag_b_rows(uint32_t (&hi)[2][2], uint32_t (&lo)[2][2],
                                            const float* Y, int nt, int ks, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldsm4(x, Y + (8 * nt + r) * kKS + 8 * ks + 4 * m);
#pragma unroll
  for (int c = 0; c < 4; ++c) split(__uint_as_float(x[c]), hi[c >> 1][c & 1], lo[c >> 1][c & 1]);
}

// B fragment with B[k][n] = Y[8 kc + pi(k)][8 nt + n], pi(t) = 2t and
// pi(t + 4) = 2t + 1: the key order of `frag_a_from_c`
__device__ __forceinline__ void frag_b_cols(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* Y,
                                            int kc, int nt, int g, int t) {
  const float* p = Y + (8 * kc + 2 * t) * kKS + 8 * nt + g;
  split(p[0], hi[0], lo[0]);
  split(p[kKS], hi[1], lo[1]);
}

// a C fragment (rows g, g + 8; columns 2t, 2t + 1) as the A fragment of the
// next product, its 8 columns taken in the order pi
__device__ __forceinline__ void frag_a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// The bf16 route: rows of bf16 in shared memory, kKSB apart.

// x0, x1 as bf16 hi and lo pairs: x ~ hi + lo to about 2^-17 of x
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A fragment (16 x 16) of shared rows at A, columns 16 kc ..
__device__ __forceinline__ void frag_a16(uint32_t (&a)[4], const __nv_bfloat16* A, int kc,
                                         int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm4(a, A + (r + 8 * (m & 1)) * kKSB + 16 * kc + 8 * (m >> 1));
}

// B fragments of n-tiles nt and nt + 1, B[k][n] = Y[8 nt + n][16 kc + k]
__device__ __forceinline__ void frag_b16_rows(uint32_t (&b)[2][2], const __nv_bfloat16* Y, int nt,
                                              int kc, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldsm4(x, Y + (8 * (nt + (m >> 1)) + r) * kKSB + 16 * kc + 8 * (m & 1));
  b[0][0] = x[0];
  b[0][1] = x[1];
  b[1][0] = x[2];
  b[1][1] = x[3];
}

// B fragments of n-tiles nt and nt + 1, B[k][n] = Y[16 kc + k][8 nt + n]
// (transposed by ldmatrix)
__device__ __forceinline__ void frag_b16_cols(uint32_t (&b)[2][2], const __nv_bfloat16* Y, int kc,
                                              int nt, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldsm4_trans(x, Y + (16 * kc + 8 * (m & 1) + r) * kKSB + 8 * (nt + (m >> 1)));
  b[0][0] = x[0];
  b[0][1] = x[1];
  b[1][0] = x[2];
  b[1][1] = x[3];
}

// The probabilities (or ds) of a tile as the next product's A operand:
// TF32 hi and lo by 8-key tile (keys in the order pi), or bf16 hi and lo
// pairs by 16-key chunk (a C fragment's pairs are an m16n8k16 A
// fragment's, as they stand).
template <typename T, int ST>
struct PFrag {
  uint32_t hi[ST][4], lo[ST][4];
};
template <int ST>
struct PFrag<__nv_bfloat16, ST> {
  uint32_t hi[ST / 2][4], lo[ST / 2][4];
};

template <int ST>
__device__ __forceinline__ void make_pfrag(PFrag<float, ST>& f, const float (&c)[ST][4]) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt) frag_a_from_c(f.hi[nt], f.lo[nt], c[nt]);
}

template <int ST>
__device__ __forceinline__ void make_pfrag(PFrag<__nv_bfloat16, ST>& f,
                                           const float (&c)[ST][4]) {
#pragma unroll
  for (int ch = 0; ch < ST / 2; ++ch) {
    split_pair(c[2 * ch][0], c[2 * ch][1], f.hi[ch][0], f.lo[ch][0]);
    split_pair(c[2 * ch][2], c[2 * ch][3], f.hi[ch][1], f.lo[ch][1]);
    split_pair(c[2 * ch + 1][0], c[2 * ch + 1][1], f.hi[ch][2], f.lo[ch][2]);
    split_pair(c[2 * ch + 1][2], c[2 * ch + 1][3], f.hi[ch][3], f.lo[ch][3]);
  }
}

// s[nt] = A[16 rows] . Y[8 nt + n]^T over the first 8 nks columns, both in
// shared memory; each 32-column k-tile summed in fresh registers (kRN).
// fp32: 3xTF32; bf16: one bf16 pass (the products exact).
template <int ST>
__device__ __forceinline__ void scores(float (&s)[ST][4], const float* A, const float* Y,
                                       int nks, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kNT; k0 += 4) {
    if (k0 < nks) {
      float part[ST][4] = {};
#pragma unroll
      for (int ks = k0; ks < k0 + 4; ks += 2) {
        if (ks < nks) {  // nks is even (kPad)
          uint32_t ah[2][4], al[2][4], bh[ST][2][2], bl[ST][2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) frag_a(ah[u], al[u], A, ks + u, 4 * g + t);
#pragma unroll
          for (int nt = 0; nt < ST; ++nt) frag_b_rows(bh[nt], bl[nt], Y, nt, ks, 4 * g + t);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int nt = 0; nt < ST; ++nt) mma3(part[nt], ah[u], al[u], bh[nt][u], bl[nt][u]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < ST; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] += part[nt][c];
    }
  }
}

template <int ST>
__device__ __forceinline__ void scores(float (&s)[ST][4], const __nv_bfloat16* A,
                                       const __nv_bfloat16* Y, int nks, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kNT; k0 += 4) {
    if (k0 < nks) {
      float part[ST][4] = {};
#pragma unroll
      for (int kc = k0 / 2; kc < k0 / 2 + 2; ++kc) {
        if (2 * kc < nks) {
          uint32_t a[4], b[ST / 2][2][2];
          frag_a16(a, A, kc, 4 * g + t);
#pragma unroll
          for (int np = 0; np < ST / 2; ++np) frag_b16_rows(b[np], Y, 2 * np, kc, 4 * g + t);
#pragma unroll
          for (int nt = 0; nt < ST; ++nt) mma16(part[nt], a, b[nt / 2][nt % 2]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < ST; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] += part[nt][c];
    }
  }
}

// acc = acc * f(row) + part (SCALE: the online softmax's rescale), else
// acc + part
template <bool SCALE>
__device__ __forceinline__ void rescale_add(float (&acc)[4], const float (&part)[4], float f0,
                                            float f1) {
  if constexpr (SCALE) {
    acc[0] = fmaf(acc[0], f0, part[0]);
    acc[1] = fmaf(acc[1], f0, part[1]);
    acc[2] = fmaf(acc[2], f1, part[2]);
    acc[3] = fmaf(acc[3], f1, part[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
  }
}

// acc[nt] (16 rows, columns 8 nt ..) = acc[nt] * f(row) + P . Y over the
// streamed tile's 8 ST rows, for nt < nks; each n-tile's sum over the tile
// in fresh registers (kRN); two n-tiles at a time (nks is even). fp32: P's
// TF32 hi and lo against Y's (3xTF32); bf16: P's bf16 hi and lo against Y.
template <bool SCALE, int ST>
__device__ __forceinline__ void values(float (&acc)[kNT][4], const PFrag<float, ST>& p,
                                       const float* Y, int nks, float f0, float f1, int g,
                                       int t) {
#pragma unroll
  for (int nt = 0; nt < kNT; nt += 2) {
    if (nt < nks) {
      float part[2][4] = {};
      uint32_t bh[ST][2][2], bl[ST][2][2];
#pragma unroll
      for (int kc = 0; kc < ST; ++kc)
#pragma unroll
        for (int u = 0; u < 2; ++u) frag_b_cols(bh[kc][u], bl[kc][u], Y, kc, nt + u, g, t);
#pragma unroll
      for (int kc = 0; kc < ST; ++kc)
#pragma unroll
        for (int u = 0; u < 2; ++u) mma3(part[u], p.hi[kc], p.lo[kc], bh[kc][u], bl[kc][u]);
#pragma unroll
      for (int u = 0; u < 2; ++u) rescale_add<SCALE>(acc[nt + u], part[u], f0, f1);
    }
  }
}

template <bool SCALE, int ST>
__device__ __forceinline__ void values(float (&acc)[kNT][4], const PFrag<__nv_bfloat16, ST>& p,
                                       const __nv_bfloat16* Y, int nks, float f0, float f1,
                                       int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kNT; nt += 2) {
    if (nt < nks) {
      float part[2][4] = {};
      uint32_t b[ST / 2][2][2];
#pragma unroll
      for (int ch = 0; ch < ST / 2; ++ch) frag_b16_cols(b[ch], Y, ch, nt, 4 * g + t);
#pragma unroll
      for (int ch = 0; ch < ST / 2; ++ch)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma16(part[u], p.lo[ch], b[ch][u]);
          mma16(part[u], p.hi[ch], b[ch][u]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) rescale_add<SCALE>(acc[nt + u], part[u], f0, f1);
    }
  }
}

// `rows` rows of `dkp` columns at src (row stride rs; the first `valid`
// real, the rest zero; columns past dk zero) -> shared rows; thread `tid`
// of `threads`. fp32 rows (kKS floats apart) by cp.async of 16 bytes
// (VEC: 16-byte aligned rows), bf16 rows (kKSB apart, kept bf16) by
// cp.async of 8 bytes (VEC: 8-byte aligned rows), or element by element.
template <bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src, int valid, int rows, int dkp,
                                          int dk, int rs, int tid, int threads) {
  constexpr int KS = Rows<T>::KS;
  const int c4n = dkp / 4;
  for (int e = tid; e < rows * c4n; e += threads) {
    const int r = e / c4n, c = (e - r * c4n) * 4;
    auto* d = dst + r * KS + c;
    if constexpr (VEC) {
      const int n = r < valid ? max(0, min(4, dk - c)) : 0;
      const T* from = n ? src + size_t(r) * rs + c : src;
      if constexpr (std::is_same<T, float>::value) {
        cp_async16(d, from, 4 * n);
      } else {
        cp_async8(d, from, 2 * n);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T x = r < valid && c + u < dk ? src[size_t(r) * rs + c + u] : from_float<T>(0.f);
        d[u] = x;
      }
    }
  }
}

// a warp's 16 output rows from its accumulators times f (rows g, g + 8):
// columns c < dk, zeros in [dk, hs); rows past `valid` not written
template <bool VEC, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kNT][4], float f0, float f1,
                                           int valid, int nks, int dk, int hs, int rs, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= valid) continue;
    T* d = dst + size_t(row) * rs;
    const float f = r ? f1 : f0;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < nks) {
        const int c = 8 * nt + 2 * t;
        const float x0 = c < dk ? acc[nt][2 * r] * f : 0.f;
        const float x1 = c + 1 < dk ? acc[nt][2 * r + 1] * f : 0.f;
        if constexpr (VEC) {
          if (c < hs) digat::store2(d + c, make_float2(x0, x1));  // hs % 4 == 0, c even
        } else {
          if (c < hs) d[c] = from_float<T>(x0);
          if (c + 1 < hs) d[c + 1] = from_float<T>(x1);
        }
      }
    }
    for (int c = 8 * nks + 2 * t; c < hs; c += 8) {  // the E layout's pad lanes
      if constexpr (VEC) {
        digat::store2(d + c, make_float2(0.f, 0.f));
      } else {
        d[c] = from_float<T>(0.f);
        if (c + 1 < hs) d[c + 1] = from_float<T>(0.f);
      }
    }
  }
}

// the row statistics (m, 1 / sum, t) of row (n, i, h), kept in the row's
// first lanes of dq between the backward's passes: 3 floats, or their bits
// in 6 bf16 slots
template <typename T>
__device__ __forceinline__ void put_stats(T* p, float a, float b, float c) {
  if constexpr (std::is_same<T, float>::value) {
    p[0] = a;
    p[1] = b;
    p[2] = c;
  } else {
    unsigned short* u = reinterpret_cast<unsigned short*>(p);
    const float x[3] = {a, b, c};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const uint32_t bits = __float_as_uint(x[e]);
      u[2 * e] = static_cast<unsigned short>(bits & 0xffffu);
      u[2 * e + 1] = static_cast<unsigned short>(bits >> 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ void get_stats(const T* p, float& a, float& b, float& c) {
  if constexpr (std::is_same<T, float>::value) {
    a = p[0];
    b = p[1];
    c = p[2];
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    float x[3];
#pragma unroll
    for (int e = 0; e < 3; ++e)
      x[e] = __uint_as_float(uint32_t(u[2 * e]) | (uint32_t(u[2 * e + 1]) << 16));
    a = x[0];
    b = x[1];
    c = x[2];
  }
}

// Where a warp works: its unit's slot in the block, the unit's first own
// row (i0), the warp's first row among them (wrow), the slot's threads, the
// unit's sequence n and the offset of its head's first element (base).
struct Place {
  int slot, i0, wrow, tid, threads, n;
  bool live;    // false: a slot past the last unit (loads the last unit's rows, no more)
  bool active;  // live and some of the warp's rows lie before L: it computes
  size_t base;
};

__device__ __forceinline__ Place place(const WideGeom& w, int units, int H, int L, int rs,
                                       int hs) {
  Place p;
  const int warp = threadIdx.x >> 5;
  p.slot = warp / w.wpu;
  p.wrow = (warp - p.slot * w.wpu) * 16;
  const int items = units * w.tpu;
  const int raw = blockIdx.x * w.upb + p.slot;
  p.live = raw < items;
  const int item = min(raw, items - 1);
  const int unit = item / w.tpu;
  p.i0 = (item - unit * w.tpu) * w.ot;
  p.n = unit / H;
  const int h = unit - p.n * H;
  p.base = size_t(p.n) * L * rs + size_t(h) * hs;
  p.active = p.live && p.i0 + p.wrow < L;
  p.tid = threadIdx.x - p.slot * w.wpu * 32;
  p.threads = w.wpu * 32;
  return p;
}

// the scores of one tile scaled and masked: key (tile row) 8 nt + 2t + e of
// row g + 8 (e >> 1); keys past L -inf, masked keys -1e9
template <int ST>
__device__ __forceinline__ void mask_scores(float (&s)[ST][4], const unsigned char* keep, int j0,
                                            int L, float scale, int t) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * nt + 2 * t + (e & 1);
      const float x = s[nt][e] * scale;
      s[nt][e] = j0 + key >= L ? -INFINITY : (keep[key] ? x : kMaskFill);
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// one online-softmax step over a tile's scores s (in place: s -> exp(s -
// m_new)) for rows g and g + 8: m, the lane's part of the sum l, and the
// factors corr by which the earlier sums shrink
template <int ST>
__device__ __forceinline__ void online_step(float (&s)[ST][4], float (&m)[2], float (&l)[2],
                                            float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));  // finite: tile 0 holds key 0
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new);
        sum += s[nt][e];
      }
    l[r] = fmaf(l[r], corr[r], sum);
  }
}

// ---------------------------------------------------------------------------
// Forward: own rows q, streamed k and v.
// ---------------------------------------------------------------------------
template <bool VEC, typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
msa_attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const unsigned char* __restrict__ mask,
                              T* __restrict__ out, int units, int H, int L, int dk, int rs,
                              int hs, float scale) {
  constexpr int KS = Rows<T>::KS, KT = Rows<T>::KT, ST = KT / 8;
  extern __shared__ float4 smem4[];
  const WideGeom w = wide_geom(L);
  const Place at = place(w, units, H, L, rs, hs);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int dkp = (dk + kPad - 1) / kPad * kPad, nks = dkp / 8;
  unsigned char* unit = reinterpret_cast<unsigned char*>(smem4) +
                        at.slot * wide_unit_bytes(kFwd, L, sizeof(T));
  T* Qs = reinterpret_cast<T*>(unit);
  unsigned char* keep = unit + w.ot * KS * sizeof(T);  // [2][KT]
  T* stream = reinterpret_cast<T*>(keep + 2 * KT);   // [stage][k, v][KT][KS]
  const int ntiles = (L + KT - 1) / KT;
  load_tile<VEC>(Qs, q + at.base + size_t(at.i0) * rs, min(w.ot, L - at.i0), w.ot, dkp, dk, rs,
                 at.tid, at.threads);
  auto fetch = [&](int jt) {
    T* st = stream + (jt & 1) * 2 * KT * KS;
    const int j0 = jt * KT, rows = min(KT, L - j0);
    load_tile<VEC>(st, k + at.base + size_t(j0) * rs, rows, KT, dkp, dk, rs, at.tid, at.threads);
    load_tile<VEC>(st + KT * KS, v + at.base + size_t(j0) * rs, rows, KT, dkp, dk, rs, at.tid,
                   at.threads);
    for (int j = at.tid; j < KT; j += at.threads)
      keep[(jt & 1) * KT + j] = j < rows && (mask == nullptr || mask[size_t(at.n) * L + j0 + j]);
    cp_async_commit();
  };
  fetch(0);
  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const T* Qw = Qs + at.wrow * KS;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) {
      fetch(jt + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    if (at.active) {  // a warp whose rows all lie past L only loads
      const T* Ks = stream + (jt & 1) * 2 * KT * KS;
      const T* Vs = Ks + KT * KS;
      float s[ST][4];
      scores(s, Qw, Ks, nks, g, t);
      mask_scores(s, keep + (jt & 1) * KT, jt * KT, L, scale, t);
      float corr[2];
      online_step(s, m, l, corr);
      PFrag<T, ST> pf;
      make_pfrag(pf, s);
      values<true>(o, pf, Vs, nks, corr[0], corr[1], g, t);
    }
    __syncthreads();  // the stage is refilled next
  }
  if (!at.live) return;
  const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
  const int r0 = at.i0 + at.wrow;
  store_rows<VEC>(out + at.base + size_t(r0) * rs, o, inv0, inv1, L - r0, nks, dk, hs, rs, g, t);
}

// ---------------------------------------------------------------------------
// Backward rows passes: own rows q and do, streamed k and v. DQ false: the
// row statistics into dq's first lanes; true: dq from them.
// ---------------------------------------------------------------------------
template <bool DQ, bool VEC, typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
msa_attention_bwd_wide_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const unsigned char* __restrict__ mask,
                                   const T* __restrict__ dout, T* __restrict__ dq, int units,
                                   int H, int L, int dk, int rs, int hs, float scale) {
  constexpr int KS = Rows<T>::KS, KT = Rows<T>::KT, ST = KT / 8;
  extern __shared__ float4 smem4[];
  const WideGeom w = wide_geom(L);
  const Place at = place(w, units, H, L, rs, hs);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int dkp = (dk + kPad - 1) / kPad * kPad, nks = dkp / 8;
  unsigned char* unit = reinterpret_cast<unsigned char*>(smem4) +
                        at.slot * wide_unit_bytes(kRows, L, sizeof(T));
  T* Qs = reinterpret_cast<T*>(unit);
  T* Ds = Qs + w.ot * KS;
  unsigned char* keep = reinterpret_cast<unsigned char*>(Ds + w.ot * KS);  // [2][KT]
  T* stream = reinterpret_cast<T*>(keep + 2 * KT);  // [stage][k, v][KT][KS]
  const int ntiles = (L + KT - 1) / KT;
  const int r0 = at.i0 + at.wrow;  // the warp's first row
  const int own = min(w.ot, L - at.i0);
  load_tile<VEC>(Qs, q + at.base + size_t(at.i0) * rs, own, w.ot, dkp, dk, rs, at.tid,
                 at.threads);
  load_tile<VEC>(Ds, dout + at.base + size_t(at.i0) * rs, own, w.ot, dkp, dk, rs, at.tid,
                 at.threads);
  // DQ: the rows' statistics, read before any row of dq is written
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tt[2] = {0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = 0.f;
      if (at.live && r0 + g + 8 * r < L)
        get_stats(dq + at.base + size_t(r0 + g + 8 * r) * rs, m[r], l[r], tt[r]);
    }
  }
  auto fetch = [&](int jt) {
    T* st = stream + (jt & 1) * 2 * KT * KS;
    const int j0 = jt * KT, rows = min(KT, L - j0);
    load_tile<VEC>(st, k + at.base + size_t(j0) * rs, rows, KT, dkp, dk, rs, at.tid, at.threads);
    load_tile<VEC>(st + KT * KS, v + at.base + size_t(j0) * rs, rows, KT, dkp, dk, rs, at.tid,
                   at.threads);
    for (int j = at.tid; j < KT; j += at.threads)
      keep[(jt & 1) * KT + j] = j < rows && (mask == nullptr || mask[size_t(at.n) * L + j0 + j]);
    cp_async_commit();
  };
  fetch(0);
  float acc[DQ ? kNT : 1][4];
#pragma unroll
  for (int nt = 0; nt < (DQ ? kNT : 1); ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  float tu[2] = {0.f, 0.f};  // !DQ: the lane's part of sum_j e_ij dp_ij
  const T* Qw = Qs + at.wrow * KS;
  const T* Dw = Ds + at.wrow * KS;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) {
      fetch(jt + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    if (at.active) {  // a warp whose rows all lie past L only loads
      const T* Ks = stream + (jt & 1) * 2 * KT * KS;
      const T* Vs = Ks + KT * KS;
      const unsigned char* kp = keep + (jt & 1) * KT;
      float s[ST][4], dp[ST][4];
      scores(s, Qw, Ks, nks, g, t);
      scores(dp, Dw, Vs, nks, g, t);
      mask_scores(s, kp, jt * KT, L, scale, t);
      if constexpr (!DQ) {
        float corr[2];
        online_step(s, m, l, corr);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float part = 0.f;
#pragma unroll
          for (int nt = 0; nt < ST; ++nt)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) part = fmaf(s[nt][e], dp[nt][e], part);
          tu[r] = fmaf(tu[r], corr[r], part);
        }
      } else {
        float ds[ST][4];
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = 8 * nt + 2 * t + (e & 1);
            const float p = expf(s[nt][e] - m[r]) * l[r];  // l holds 1 / sum here
            ds[nt][e] = jt * KT + key < L && kp[key] ? p * (dp[nt][e] - tt[r]) * scale : 0.f;
          }
        }
        PFrag<T, ST> df;
        make_pfrag(df, ds);
        values<false>(acc, df, Ks, nks, 1.f, 1.f, g, t);
      }
    }
    __syncthreads();
  }
  if (!at.live) return;
  if constexpr (!DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
      const float trow = quad_sum(tu[r]) * inv;
      const int row = r0 + g + 8 * r;
      if (t == 0 && row < L) put_stats(dq + at.base + size_t(row) * rs, m[r], inv, trow);
    }
  } else {
    store_rows<VEC>(dq + at.base + size_t(r0) * rs, acc, 1.f, 1.f, L - r0, nks, dk, hs, rs, g,
                    t);
  }
}

// ---------------------------------------------------------------------------
// Backward column pass: own rows k and v (keys), streamed q and do with the
// rows' statistics from dq's first lanes; dk and dv.
// ---------------------------------------------------------------------------
template <bool VEC, typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
msa_attention_bwd_wide_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const unsigned char* __restrict__ mask,
                                   const T* __restrict__ dout, const T* __restrict__ stats,
                                   T* __restrict__ dk_out, T* __restrict__ dv_out, int units,
                                   int H, int L, int dk, int rs, int hs, float scale) {
  constexpr int KS = Rows<T>::KS, KT = Rows<T>::KT, ST = KT / 8;
  extern __shared__ float4 smem4[];
  const WideGeom w = wide_geom(L);
  const Place at = place(w, units, H, L, rs, hs);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int dkp = (dk + kPad - 1) / kPad * kPad, nks = dkp / 8;
  unsigned char* unit = reinterpret_cast<unsigned char*>(smem4) +
                        at.slot * wide_unit_bytes(kCols, L, sizeof(T));
  T* Ks = reinterpret_cast<T*>(unit);
  T* Vs = Ks + w.ot * KS;
  float* St = reinterpret_cast<float*>(Vs + w.ot * KS);  // [stage][m, 1 / sum, t][KT]
  unsigned char* keep = reinterpret_cast<unsigned char*>(St + 2 * 3 * KT);  // [ot]
  T* stream = reinterpret_cast<T*>(keep + w.ot);  // [stage][q, do][KT][KS]
  const int ntiles = (L + KT - 1) / KT;
  const int own = min(w.ot, L - at.i0);
  load_tile<VEC>(Ks, k + at.base + size_t(at.i0) * rs, own, w.ot, dkp, dk, rs, at.tid,
                 at.threads);
  load_tile<VEC>(Vs, v + at.base + size_t(at.i0) * rs, own, w.ot, dkp, dk, rs, at.tid,
                 at.threads);
  for (int j = at.tid; j < w.ot; j += at.threads)
    keep[j] = j < own && (mask == nullptr || mask[size_t(at.n) * L + at.i0 + j]);
  auto fetch = [&](int it) {
    T* st = stream + (it & 1) * 2 * KT * KS;
    const int i0 = it * KT, rows = min(KT, L - i0);
    load_tile<VEC>(st, q + at.base + size_t(i0) * rs, rows, KT, dkp, dk, rs, at.tid, at.threads);
    load_tile<VEC>(st + KT * KS, dout + at.base + size_t(i0) * rs, rows, KT, dkp, dk, rs,
                   at.tid, at.threads);
    for (int i = at.tid; i < KT; i += at.threads) {
      float a = 0.f, b = 0.f, c = 0.f;  // rows past L: p = 0
      if (i < rows) get_stats(stats + at.base + size_t(i0 + i) * rs, a, b, c);
      float* sp = St + (it & 1) * 3 * KT;
      sp[i] = a;
      sp[KT + i] = b;
      sp[2 * KT + i] = c;
    }
    cp_async_commit();
  };
  fetch(0);
  float gk[kNT][4], gv[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) gk[nt][c] = gv[nt][c] = 0.f;
  const T* Kw = Ks + at.wrow * KS;
  const T* Vw = Vs + at.wrow * KS;
  bool kept[2] = {false, false};
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      fetch(it + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    if (at.active) {  // a warp whose rows all lie past L only loads
      if (it == 0) {
        kept[0] = keep[at.wrow + g];
        kept[1] = keep[at.wrow + g + 8];
      }
      const T* Qt = stream + (it & 1) * 2 * KT * KS;
      const T* Dt = Qt + KT * KS;
      const float* sp = St + (it & 1) * 3 * KT;
      float s[ST][4], dp[ST][4];
      scores(s, Kw, Qt, nks, g, t);   // s^T: rows the warp's keys, columns the tile's rows
      scores(dp, Vw, Dt, nks, g, t);  // dp^T
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = 8 * nt + 2 * t + (e & 1);
          const float x = kept[r] ? s[nt][e] * scale : kMaskFill;
          const float p = expf(x - sp[i]) * sp[KT + i];
          dp[nt][e] = kept[r] ? p * (dp[nt][e] - sp[2 * KT + i]) * scale : 0.f;  // ds
          s[nt][e] = p;
        }
      }
      PFrag<T, ST> pf, df;
      make_pfrag(pf, s);
      make_pfrag(df, dp);
      values<false>(gv, pf, Dt, nks, 1.f, 1.f, g, t);
      values<false>(gk, df, Qt, nks, 1.f, 1.f, g, t);
    }
    __syncthreads();
  }
  if (!at.live) return;
  const int r0 = at.i0 + at.wrow;
  store_rows<VEC>(dk_out + at.base + size_t(r0) * rs, gk, 1.f, 1.f, L - r0, nks, dk, hs, rs, g,
                  t);
  store_rows<VEC>(dv_out + at.base + size_t(r0) * rs, gv, 1.f, 1.f, L - r0, nks, dk, hs, rs, g,
                  t);
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// blocks of a launch at L, or 0 where the grid would pass INT_MAX
int wide_blocks(int units, int L) {
  const WideGeom w = wide_geom(L);
  const long long items = static_cast<long long>(units) * w.tpu;
  return items > INT_MAX ? 0 : static_cast<int>((items + w.upb - 1) / w.upb);
}

}  // namespace

namespace digat {

template <typename T>
cudaError_t attention_wide_init(int max_smem) {
  cudaError_t e = cudaSuccess;
  auto allow = [&](auto kern) {
    if (e == cudaSuccess) e = allow_smem(kern, max_smem);
  };
  allow(msa_attention_fwd_wide_kernel<false, T>);
  allow(msa_attention_fwd_wide_kernel<true, T>);
  allow(msa_attention_bwd_wide_rows_kernel<false, false, T>);
  allow(msa_attention_bwd_wide_rows_kernel<false, true, T>);
  allow(msa_attention_bwd_wide_rows_kernel<true, false, T>);
  allow(msa_attention_bwd_wide_rows_kernel<true, true, T>);
  allow(msa_attention_bwd_wide_cols_kernel<false, T>);
  allow(msa_attention_bwd_wide_cols_kernel<true, T>);
  return e;
}

template <typename T>
cudaError_t attention_fwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask,
                               T* out, int N, int H, int L, int dk, int rs, int hs, float scale,
                               bool vec, int max_smem, cudaStream_t stream) {
  const size_t smem = wide_block_bytes(kFwd, L, sizeof(T));
  const int blocks = wide_blocks(N * H, L);
  if (smem > size_t(max_smem) || blocks == 0) return cudaErrorInvalidValue;
  const auto kern = vec ? msa_attention_fwd_wide_kernel<true, T>
                        : msa_attention_fwd_wide_kernel<false, T>;
  kern<<<blocks, kWarps * 32, smem, stream>>>(q, k, v, mask, out, N * H, H, L, dk, rs, hs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_bwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask,
                               const T* dout, T* dq, T* dk_out, T* dv_out, int N, int H, int L,
                               int dk, int rs, int hs, float scale, bool vec, int max_smem,
                               cudaStream_t stream) {
  const size_t rows_smem = wide_block_bytes(kRows, L, sizeof(T));
  const size_t cols_smem = wide_block_bytes(kCols, L, sizeof(T));
  const int blocks = wide_blocks(N * H, L), units = N * H;
  if (rows_smem > size_t(max_smem) || cols_smem > size_t(max_smem) || blocks == 0)
    return cudaErrorInvalidValue;
  const auto stats = vec ? msa_attention_bwd_wide_rows_kernel<false, true, T>
                         : msa_attention_bwd_wide_rows_kernel<false, false, T>;
  const auto cols = vec ? msa_attention_bwd_wide_cols_kernel<true, T>
                        : msa_attention_bwd_wide_cols_kernel<false, T>;
  const auto rows = vec ? msa_attention_bwd_wide_rows_kernel<true, true, T>
                        : msa_attention_bwd_wide_rows_kernel<true, false, T>;
  stats<<<blocks, kWarps * 32, rows_smem, stream>>>(q, k, v, mask, dout, dq, units, H, L, dk, rs,
                                                   hs, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cols<<<blocks, kWarps * 32, cols_smem, stream>>>(q, k, v, mask, dout, dq, dk_out, dv_out, units,
                                                  H, L, dk, rs, hs, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rows<<<blocks, kWarps * 32, rows_smem, stream>>>(q, k, v, mask, dout, dq, units, H, L, dk, rs,
                                                  hs, scale);
  return cudaGetLastError();
}

template cudaError_t attention_wide_init<float>(int);
template cudaError_t attention_wide_init<__nv_bfloat16>(int);
template cudaError_t attention_fwd_wide<float>(const float*, const float*, const float*,
                                               const unsigned char*, float*, int, int, int, int,
                                               int, int, float, bool, int, cudaStream_t);
template cudaError_t attention_fwd_wide<__nv_bfloat16>(const __nv_bfloat16*,
                                                       const __nv_bfloat16*,
                                                       const __nv_bfloat16*,
                                                       const unsigned char*, __nv_bfloat16*, int,
                                                       int, int, int, int, int, float, bool, int,
                                                       cudaStream_t);
template cudaError_t attention_bwd_wide<float>(const float*, const float*, const float*,
                                               const unsigned char*, const float*, float*,
                                               float*, float*, int, int, int, int, int, int,
                                               float, bool, int, cudaStream_t);
template cudaError_t attention_bwd_wide<__nv_bfloat16>(
    const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, const unsigned char*,
    const __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
    int, float, bool, int, cudaStream_t);

}  // namespace digat
