// The masked attention pair's bf16 register-row instance (compute_dtype
// bfloat16, heads of dk <= 64), forward and backward, on the tensor cores:
// what the kernels share. The kernels are msa_attention_bf16.cu (the
// resident forward and backward, L <= kResL = 64, and the entry points)
// and msa_attention_bf16_long.cu (the streamed ones past kResL), which nvcc
// compiles in parallel.
//
// Replaces digat_tpu/ops/pallas/msa_attention_grouped.py (_fwd_kernel,
// _bwd_kernel; `pallas_call` at :292) and digat_tpu/ops/pallas/
// msa_attention.py (_fwd_kernel :51, _bwd_kernel :75; `pallas_call` at
// :141 and :177) at bf16 and dk <= 64. The function is the one that
// msa_attention_kernels.cuh's header note states: bf16 q, k, v and do taken
// into fp32 arithmetic, the mask a select, keys past L scoring -inf and
// masked keys -1e9, each output rounded once to bf16, nearest even.
//
// What bounds it on an H100: bytes. At the NRMS titles (L 32, dk 20) the
// forward does 4 L dk FLOP per head and row against 8 dk bytes (q, k, v and
// out in bf16): 16 FLOP a byte, far below the 295 at which the bf16 tensor
// cores would take over from HBM (3.35 TB/s). The fp32 kernels that the
// bf16 instance used to instantiate ran every product as a scalar FMA fed
// from shared memory, which made them slower than the bytes by 4-80 times.
//
// Design.
//  * Rows are copied as bf16, 16 bytes at a time (cp.async), and never pass
//    through registers. A block owns one sequence and a group of g heads
//    whose columns start and end on 16 bytes: g = 8 / gcd(hs, 8) (hs 20: 2
//    heads, 80 bytes; hs 25: 8 heads, 400 bytes; hs 8, 16, 24, 32, 48, 64:
//    one), at most H. It copies the span of the group's columns that its
//    heads read, each row to a shared row of `sr` elements (the span
//    rounded up to 16 bytes, plus 16 bytes where that is a multiple of 32:
//    rows 16 bytes off a multiple of 32 put the fragment patterns below on
//    distinct banks). A head's shift inside the span lives in the shared
//    index, so a head need not start on 16 bytes. Where the row stride or a
//    pointer is not 16-byte aligned the same kernels take element copies
//    and groups of one head (`vec` false, chosen at launch;
//    ops/msa_attention.py's `launch_plan` states the rule).
//  * Products on mma.sync.m16n8k16 bf16 with fp32 accumulators; dk is
//    zero-padded to a multiple of 16 (20 and 25 -> 32). q k^T and do v^T
//    take their bf16 rows as they are (one pass, the products exact in
//    fp32). p v, ds k, ds^T q and p^T do take the fp32 p or ds as a bf16 hi
//    and lo (lo = bf16(x - hi), x to about 2^-17) against bf16 rows: two
//    passes. Each 32-column k-tile of a score and each tile's part of an
//    output row is summed in fresh registers and added rounding to nearest
//    (kRN, as A, A', B and the wide pair: the tensor cores' own adds
//    truncate). The scores' C fragment is the next product's A fragment as
//    it stands (a lane's pairs of keys are an m16n8k16 A fragment's).
//    Fragments are read from the shared rows with 32-bit loads where the
//    head's offset is even (EVEN: hs even) and 16-bit loads otherwise;
//    columns past dk are masked to zero (`Lane`).
//  * Outputs are staged in shared memory in the span's layout (a head's pad
//    lanes [dk, hs) zero) and stored as 16-byte rows of the group.
//  * Each output element is summed by one lane in a fixed order, with no
//    float atomics: the same bits on every run.
//
// ops/msa_attention.py's `bf16_geometry` and `_bf16_smem_bytes` state the
// same geometry and shared memory; tests/test_torch_attention_tiles.py
// replays the order of work in float64.
#pragma once

#include "msa_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKT = 32;     // keys of a tile of scores (and rows of a streamed tile)
constexpr int kBWarps = 8;  // warps of a streamed block at most
constexpr int kRWarps = 4;  // warps of a resident block at most
// blocks an SM that __launch_bounds__ asks registers for: three resident
// blocks (at most 170 registers a thread), two streamed forward blocks
// (128); the streamed backward takes what it needs
constexpr int kRMinBlocks = 3;
constexpr int kFwdLongMinBlocks = 2;
constexpr int kResL = 64;   // the longest L whose rows a block holds whole
constexpr int kStages = 3;  // units a resident block has in flight at most
// the kernels: resident (a block holds a group's rows whole, L <= kResL,
// and walks over units with their copies in flight) and streamed (L >
// kResL, one block a unit and its chunk of rows, the other side's rows in
// tiles)
enum BKind : int { kBFwd = 0, kBShort = 1, kBMid = 2, kBFwdLong = 3, kBLong = 4 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Geometry of a launch (as ops/msa_attention.py's `bf16_geometry`): g heads
// a group, groups a sequence, a span row's elements (se) and the shared
// row stride (sr), a block's own rows (qr: L rounded up to 16 where the
// block holds the rows whole; else its chunk of query rows, or of keys in
// the long backward's column pass) and its warps. A task is a head and 32
// rows in the forwards (two m16 tiles against each key fragment), 16 in the
// backwards; resident kernels run at most kRWarps warps, which take the
// tasks in turn; streamed kernels one warp a task.
struct BGeom {
  int g, groups, se, sr, qr, warps;
};

__host__ __device__ inline BGeom bgeom(int kind, int L, int H, int hs, bool vec) {
  BGeom b;
  int gcd = 8;
  while (hs % gcd) gcd >>= 1;
  b.g = vec ? 8 / gcd : 1;
  const int lp = round_up(L, 16);
  if (b.g > H) b.g = H;
  b.groups = (H + b.g - 1) / b.g;
  b.se = round_up(b.g * hs, 8);
  b.sr = (b.se / 8) % 2 ? b.se : b.se + 8;
  if (kind == kBFwd || kind == kBShort || kind == kBMid) {
    const int tasks = b.g * (kind == kBFwd ? (lp + 31) / 32 : lp / 16);
    b.qr = lp;
    b.warps = tasks < kRWarps ? tasks : kRWarps;
  } else {  // streamed: a task of 32 rows in the forward, 16 in the backward
    const int rows = kind == kBFwdLong ? 32 : 16;
    const int q = rows * (b.g >= 4 ? 1 : 4 / b.g);
    b.qr = q < lp ? q : lp;
    b.warps = b.g * ((b.qr + rows - 1) / rows);
  }
  return b;
}

// shared memory of one block with `stages` units in flight (resident
// kernels), every part a multiple of 16 bytes:
//   forward, resident: a stage per unit of q, k and v [lp][sr] and the mask
//     bytes [lp] (out is staged over q);
//   backward, resident: a stage per unit of q, do, k and v [lp][sr] and the
//     mask bytes (dk and dv are staged over k and v); the staged dq
//     [lp][sr]; at L <= kShortL per head p and ds as bf16 hi and lo
//     [lp][lp + 8], else m, 1 / sum and t per head and row (floats);
//   forward, streamed: q [qr][sr]; two stages of k and v [kKT][sr] and
//     their keys' mask bytes;
//   backward, streamed: its own rows (q and do, then k and v) [qr][sr]; two
//     stages of two streamed arrays [kKT][sr]; m, 1 / sum and t per head
//     and row (rows rounded up to kKT); the mask bytes of the sequence
__host__ __device__ inline size_t bf16_smem(int kind, int L, const BGeom& b, int stages) {
  const size_t row = 2 * size_t(b.sr), lp = round_up(L, 16);
  if (kind == kBFwd) return stages * (3 * lp * row + lp);
  if (kind == kBShort || kind == kBMid) {
    const size_t own = kind == kBShort ? size_t(b.g) * 4 * lp * (lp + 8) * 2
                                       : 3 * size_t(b.g) * lp * 4;
    return stages * (4 * lp * row + lp) + lp * row + own;
  }
  if (kind == kBFwdLong) return b.qr * row + 2 * (2 * kKT * row + kKT);
  const size_t lr = round_up(L, kKT);
  return 2 * b.qr * row + 2 * 2 * kKT * row + 3 * size_t(b.g) * lr * 4 + lr;
}

// the units a resident block has in flight: the most up to kStages whose
// shared memory fits max_smem (0: not one fits); 1 for a streamed kernel
__host__ __device__ inline int bf16_stages(int kind, int L, const BGeom& b, size_t max_smem) {
  if (kind == kBFwdLong || kind == kBLong) return bf16_smem(kind, L, b, 1) <= max_smem ? 1 : 0;
  for (int s = kStages; s >= 1; --s) {
    if (bf16_smem(kind, L, b, s) <= max_smem) return s;
  }
  return 0;
}

// 16 bytes, zero-filled past `bytes`
__device__ __forceinline__ void cp_async16b(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of a span at A operands srcs[a] + base (row stride rs;
// the first `valid` rows real, the rest zero), `width` elements of each ->
// shared rows sr apart at dst + a * astride, thread tid of `threads`: `vec`
// by cp.async of 16 bytes (the span starts on 16 bytes; its last chunk may
// read past `width`, inside the row), else element by element. The
// operands share each (row, chunk), which is stepped, not divided.
template <int A>
__device__ __forceinline__ void load_spans(bool vec, bf16* __restrict__ dst, int astride,
                                           const bf16* const (&srcs)[A], size_t base, int valid,
                                           int rows, int width, int rs, int sr, int tid,
                                           int threads) {
  const int n = vec ? (width + 7) / 8 : width, dr = threads / n, dc = threads - dr * n;
  int r = tid / n, c = tid - r * n;
  while (r < rows) {
    const bool ok = r < valid;
    const int from = ok ? r * rs + (vec ? 8 * c : c) : 0, to = r * sr + (vec ? 8 * c : c);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bf16* src = srcs[a] + base;
      if (vec) {
        cp_async16b(dst + a * astride + to, src + from, ok ? 16 : 0);
      } else {
        dst[a * astride + to] = ok ? src[from] : __float2bfloat16_rn(0.f);
      }
    }
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// rows [0, rows) of `width` elements from A staged spans srcs[a] (shared
// rows sr apart) -> dsts[a] + base (row stride rs): `vec` as 16-byte chunks
// (a last partial chunk element by element), else element by element; the
// operands share each (row, chunk)
template <int A>
__device__ __forceinline__ void store_spans(bool vec, bf16* const (&dsts)[A], size_t base,
                                            const bf16* const (&srcs)[A], int rows, int width,
                                            int rs, int sr, int tid, int threads) {
  const int n = vec ? (width + 7) / 8 : width, dr = threads / n, dc = threads - dr * n;
  int r = tid / n, c = tid - r * n;
  while (r < rows) {
    const int to = r * rs + (vec ? 8 * c : c), from = r * sr + (vec ? 8 * c : c);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      bf16* dst = dsts[a] + base;
      if (!vec) {
        dst[to] = srcs[a][from];
      } else if (8 * c + 8 <= width) {
        *reinterpret_cast<uint4*>(dst + to) = *reinterpret_cast<const uint4*>(srcs[a] + from);
      } else {
        for (int u = 0; u < width - 8 * c; ++u) dst[to + u] = srcs[a][from + u];
      }
    }
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

__device__ __forceinline__ uint32_t bits(bf16 x) { return __bfloat16_as_ushort(x); }

// What a lane reads of a head's shared rows (rows sr elements apart, dk
// columns, NT 8-column tiles of dk padded to 16), fixed for a launch, so
// that a fragment's load is an add, the load and a mask: m16n8k16's lane 4
// g + t holds, of an A fragment (16 x 16), rows g and g + 8 and columns 2t,
// 2t + 1 and 2t + 8, 2t + 9; of a B fragment (16 x 8) rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g. A column past dk reads column 0 and is masked
// to 0, without a branch (the lanes of a fragment differ in it). EVEN: the
// head's offset is even (hs is), so a pair of columns is one 32-bit load;
// else two 16-bit loads.
template <int NT, bool EVEN>
struct Lane {
  static constexpr int NKC = NT / 2;
  int g, t, sr, dk, gsr, tsr;
  int ac[2 * NKC];       // columns 16 kc + 8 h + 2t (h = 0, 1), or 0 past dk
  uint32_t am[2 * NKC];  // the masks of their pairs
  int bc[NT];            // columns 8 nt + g, or 0 past dk
  uint32_t bm[NT];
  __device__ __forceinline__ Lane(int sr_, int dk_) : sr(sr_), dk(dk_) {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    gsr = g * sr;
    tsr = 2 * t * sr;
#pragma unroll
    for (int i = 0; i < 2 * NKC; ++i) {
      const int c = 8 * i + 2 * t;
      ac[i] = c < dk ? c : 0;
      am[i] = c + 1 < dk ? 0xffffffffu : (c < dk ? 0xffffu : 0u);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + g;
      bc[nt] = c < dk ? c : 0;
      bm[nt] = c < dk ? 0xffffffffu : 0u;
    }
  }
  // columns c, c + 1 at p
  __device__ __forceinline__ uint32_t pair(const bf16* p) const {
    if constexpr (EVEN) {
      return *reinterpret_cast<const uint32_t*>(p);
    } else {
      return bits(p[0]) | (bits(p[1]) << 16);
    }
  }
  // rows r, r + 1 of one column at p
  __device__ __forceinline__ uint32_t down(const bf16* p) const {
    return bits(p[0]) | (bits(p[sr]) << 16);
  }
};

// A fragment of a head's rows r0.. (at h), columns 16 kc ..
template <int NT, bool EVEN>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* h, int r0, int kc,
                                       const Lane<NT, EVEN>& ln) {
  const bf16* p = h + r0 * ln.sr + ln.gsr;
  const int c0 = ln.ac[2 * kc], c1 = ln.ac[2 * kc + 1], s8 = 8 * ln.sr;
  a[0] = ln.pair(p + c0) & ln.am[2 * kc];
  a[1] = ln.pair(p + s8 + c0) & ln.am[2 * kc];
  a[2] = ln.pair(p + c1) & ln.am[2 * kc + 1];
  a[3] = ln.pair(p + s8 + c1) & ln.am[2 * kc + 1];
}

// B[k][n] = Y[r0 + n][16 kc + k]: the rows of an 8-row tile as columns
template <int NT, bool EVEN>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const bf16* h, int r0, int kc,
                                            const Lane<NT, EVEN>& ln) {
  const bf16* p = h + r0 * ln.sr + ln.gsr;
  b[0] = ln.pair(p + ln.ac[2 * kc]) & ln.am[2 * kc];
  b[1] = ln.pair(p + ln.ac[2 * kc + 1]) & ln.am[2 * kc + 1];
}

// B[k][n] = Y[k0 + k][8 nt + n]
template <int NT, bool EVEN>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[2], const bf16* h, int k0, int nt,
                                            const Lane<NT, EVEN>& ln) {
  const bf16* p = h + k0 * ln.sr + ln.tsr + ln.bc[nt];
  b[0] = ln.down(p) & ln.bm[nt];
  b[1] = ln.down(p + 8 * ln.sr) & ln.bm[nt];
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x0, x1 as bf16 hi and lo pairs: x ~ hi + lo to about 2^-17 of x
__device__ __forceinline__ void hi_lo(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A 32-key tile's C fragments (rows g, g + 8; keys 8 nt + 2t, + 1) as the
// A fragments (hi and lo) of its two 16-key chunks
struct Split {
  uint32_t hi[2][4], lo[2][4];
};

// (the tile's C fragments start at c[n0])
template <int ST>
__device__ __forceinline__ void split_tile(Split& f, const float (&c)[ST][4], int n0 = 0) {
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const float* a = c[n0 + 2 * ch];
    const float* b = c[n0 + 2 * ch + 1];
    hi_lo(a[0], a[1], f.hi[ch][0], f.lo[ch][0]);
    hi_lo(a[2], a[3], f.hi[ch][1], f.lo[ch][1]);
    hi_lo(b[0], b[1], f.hi[ch][2], f.lo[ch][2]);
    hi_lo(b[2], b[3], f.hi[ch][3], f.lo[ch][3]);
  }
}

// the A fragments (16 rows at r0) of a head's rows over its NKC 16-column
// chunks
template <int NT, bool EVEN>
__device__ __forceinline__ void rows_frags(uint32_t (&a)[NT / 2][4], const bf16* h, int r0,
                                           const Lane<NT, EVEN>& ln) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) frag_a(a[kc], h, r0, kc, ln);
}

// s[nt] = A . Y[y0 + 8 nt ..]^T for the 8-row tiles nt < ST (rows past the
// operand's end read whatever follows; the caller masks those scores with
// a select); each 32-column k-tile (two chunks) summed in fresh registers
// and added rounding to nearest
template <int ST, int NT, bool EVEN>
__device__ __forceinline__ void scores(float (&s)[ST][4], const uint32_t (&a)[NT / 2][4],
                                       const bf16* Y, int y0, const Lane<NT, EVEN>& ln) {
  constexpr int NKC = NT / 2;
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < NKC; k0 += 2) {
    float part[ST][4] = {};
#pragma unroll
    for (int kc = k0; kc < k0 + 2 && kc < NKC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        uint32_t b[2];
        frag_b_rows(b, Y, y0 + 8 * nt, kc, ln);
        mma_bf16(k0 == 0 ? s[nt] : part[nt], a[kc], b);
      }
    }
    if (k0 > 0) {
#pragma unroll
      for (int nt = 0; nt < ST; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] += part[nt][c];
    }
  }
}

// scores of two 16-row tiles against the same keys: each B fragment read
// once for both (as `scores`, ST 4)
template <int NT, bool EVEN>
__device__ __forceinline__ void scores2(float (&s)[2][4][4], const uint32_t (&a)[2][NT / 2][4],
                                        const bf16* Y, int y0, const Lane<NT, EVEN>& ln) {
  constexpr int NKC = NT / 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mt][nt][c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < NKC; k0 += 2) {
    float part[2][4][4] = {};
#pragma unroll
    for (int kc = k0; kc < k0 + 2 && kc < NKC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b[2];
        frag_b_rows(b, Y, y0 + 8 * nt, kc, ln);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(k0 == 0 ? s[mt][nt] : part[mt][nt], a[mt][kc], b);
      }
    }
    if (k0 > 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][nt][c] += part[mt][nt][c];
    }
  }
}

// acc = acc * f(row) + part (SCALE: the online softmax's rescale), else
// acc + part
template <bool SCALE>
__device__ __forceinline__ void add_part(float (&acc)[4], const float (&part)[4], float f0,
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

// acc[nt] (16 rows, columns 8 nt ..) = acc[nt] * f(row) + P . Y[y0 + k][..]
// over a 32-row tile (its second 16-row chunk only where `live` passes 16:
// rows past the operand's end may hold anything, and 0 times a NaN is a
// NaN); P as bf16 hi and lo (lo first); each column tile's part in fresh
// registers (kRN)
template <bool SCALE, int NT, bool EVEN>
__device__ __forceinline__ void values(float (&acc)[NT][4], const Split& p, const bf16* Y, int y0,
                                       int live, float f0, float f1, const Lane<NT, EVEN>& ln) {
  const bool two = live > 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float part[4] = {};
    uint32_t b[2];
    frag_b_cols(b, Y, y0, nt, ln);
    mma_bf16(part, p.lo[0], b);
    mma_bf16(part, p.hi[0], b);
    if (two) {
      frag_b_cols(b, Y, y0 + 16, nt, ln);
      mma_bf16(part, p.lo[1], b);
      mma_bf16(part, p.hi[1], b);
    }
    add_part<SCALE>(acc[nt], part, f0, f1);
  }
}

// `values` for two 16-row tiles against the same rows of Y: each B
// fragment read once for both; SCALE rescales tile mt's rows by corr[mt]
template <bool SCALE, int NT, bool EVEN>
__device__ __forceinline__ void values2(float (&acc)[2][NT][4], const Split (&p)[2], const bf16* Y,
                                        int y0, int live, const float (&corr)[2][2],
                                        const Lane<NT, EVEN>& ln) {
  const bool two = live > 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float part[2][4] = {};
    uint32_t b[2];
    frag_b_cols(b, Y, y0, nt, ln);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(part[mt], p[mt].lo[0], b);
      mma_bf16(part[mt], p[mt].hi[0], b);
    }
    if (two) {
      frag_b_cols(b, Y, y0 + 16, nt, ln);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(part[mt], p[mt].lo[1], b);
        mma_bf16(part[mt], p[mt].hi[1], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) add_part<SCALE>(acc[mt][nt], part[mt], corr[mt][0], corr[mt][1]);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
}

// a warp's 16 output rows (r0 + g, r0 + g + 8) times f into a head's
// columns of the staged span: columns c < dk rounded to bf16, zeros in [dk,
// hs) (the E layout's pad lanes); a pair of columns one 32-bit store where
// the head's offset is even
template <int NT, bool EVEN>
__device__ __forceinline__ void stage_rows(bf16* h, const float (&acc)[NT][4], float f0, float f1,
                                           int r0, int hs, const Lane<NT, EVEN>& ln) {
  const int t = ln.t, dk = ln.dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* d = h + (r0 + 8 * r) * ln.sr + ln.gsr;
    const float f = r ? f1 : f0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + 2 * t;
      const __nv_bfloat162 x = __floats2bfloat162_rn(c < dk ? acc[nt][2 * r] * f : 0.f,
                                                     c + 1 < dk ? acc[nt][2 * r + 1] * f : 0.f);
      if constexpr (EVEN) {
        if (c < hs) *reinterpret_cast<__nv_bfloat162*>(d + c) = x;  // hs even: so is c + 1 < hs
      } else {
        if (c < hs) d[c] = x.x;
        if (c + 1 < hs) d[c + 1] = x.y;
      }
    }
    for (int c = 8 * NT + 2 * t; c < hs; c += 8) {
      d[c] = __float2bfloat16_rn(0.f);
      if (c + 1 < hs) d[c + 1] = __float2bfloat16_rn(0.f);
    }
  }
}

// a tile's keys as two bitmasks (bit j: key j0 + j): before L, and kept
// (before L and unmasked); one mask byte a lane and two ballots
__device__ __forceinline__ void key_bits(const unsigned char* keep, int j0, int L, int lane,
                                         uint32_t& live, uint32_t& kept) {
  const bool in = j0 + lane < L;
  live = __ballot_sync(0xffffffffu, in);
  kept = __ballot_sync(0xffffffffu, in && keep[in ? lane : 0]);
}

// the scores of a tile of 8 ST <= 32 keys scaled and masked: key 8 nt + 2t
// + (e & 1) of row g + 8 (e >> 1); keys past L -inf, masked keys -1e9
template <int ST>
__device__ __forceinline__ void mask_tile(float (&s)[ST][4], uint32_t live, uint32_t kept,
                                          float scale, int t) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * nt + 2 * t + (e & 1);
      const float x = (kept >> key) & 1u ? s[nt][e] * scale : kMaskFill;
      s[nt][e] = (live >> key) & 1u ? x : -INFINITY;
    }
}

// dp of keys past L set to 0 (their rows may lie past the operand's end
// and hold anything, while their p is 0: 0 times a NaN is a NaN)
template <int ST>
__device__ __forceinline__ void zero_dead(float (&dp)[ST][4], uint32_t live, int t) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((live >> (8 * nt + 2 * t + (e & 1))) & 1u)) dp[nt][e] = 0.f;
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

// one online-softmax step over a tile's scores (in place: s -> exp(s -
// m_new)) for rows g and g + 8: m, the lane's part of the sum l, and the
// factors corr by which the earlier sums shrink
__device__ __forceinline__ void online_step(float (&s)[4][4], float (&m)[2], float (&l)[2],
                                            float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));  // finite: tile 0 holds key 0
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new);
        sum += s[nt][e];
      }
    l[r] = fmaf(l[r], corr[r], sum);
  }
}

// Where a block works: its sequence n, its group's first head h0 and heads
// gh, and the offset of the group's first element (base)
struct BPlace {
  int n, h0, gh;
  size_t base;
};

__device__ __forceinline__ BPlace bplace(int unit, const BGeom& b, int H, int L, int rs, int hs) {
  BPlace p;
  p.n = unit / b.groups;
  p.h0 = (unit - p.n * b.groups) * b.g;
  p.gh = min(b.g, H - p.h0);
  p.base = size_t(p.n) * L * rs + size_t(p.h0) * hs;
  return p;
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n >= 2) {
    cp_wait<2>();
  } else if (n == 1) {
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
}

// a group's rows [lp][sr] of A operands at srcs and its mask bytes [lp]
// into a stage (the operands one after another, then the bytes)
template <int A>
__device__ __forceinline__ void issue_unit(bool vec, unsigned char* stage,
                                           const bf16* const (&srcs)[A],
                                           const unsigned char* mask, const BPlace& at, int L,
                                           int lp, int width, int rs, int sr) {
  bf16* dst = reinterpret_cast<bf16*>(stage);
  load_spans<A>(vec, dst, lp * sr, srcs, at.base, L, lp, width, rs, sr, threadIdx.x, blockDim.x);
  unsigned char* keep = reinterpret_cast<unsigned char*>(dst + A * lp * sr);
  for (int j = threadIdx.x; j < lp; j += blockDim.x)
    keep[j] = j < L && (mask == nullptr || mask[size_t(at.n) * L + j]);
}

// (blocks, stages, shared bytes) of a resident launch of `kern` with
// `warps` warps: as many blocks as are resident on the card at once, at
// most one a unit; blocks 0 where not one stage fits or no block is resident
template <typename K>
void resident_plan(K kern, int kind, int L, const BGeom& b, int units, int max_smem, int sms,
                   int& blocks, int& stages, size_t& smem) {
  blocks = 0;
  stages = bf16_stages(kind, L, b, size_t(max_smem));
  if (stages == 0) return;
  smem = bf16_smem(kind, L, b, stages);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * b.warps, smem) !=
      cudaSuccess)
    return;
  const long long most = static_cast<long long>(per_sm) * sms;
  blocks = static_cast<int>(most < units ? most : units);
}

template <typename K>
cudaError_t allow_bf16_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

namespace digat {

// the streamed kernels (msa_attention_bf16_long.cu, L > kResL): their
// shared-memory limit (once per device) and their launches with 16-byte
// copies (vec) or element ones; cudaErrorInvalidValue where a block's
// shared memory passes max_smem
cudaError_t attention_bf16_long_init(int max_smem);
// the resident backward (msa_attention_bf16_bwd.cu, L <= kResL), with the
// device's `sms` multiprocessors
cudaError_t attention_bf16_bwd_init(int max_smem);
cudaError_t attention_bf16_bwd_resident(const bf16* q, const bf16* k, const bf16* v,
                                        const unsigned char* mask, const bf16* dout, bf16* dq,
                                        bf16* dk_out, bf16* dv_out, int N, int H, int L, int dk,
                                        int rs, int hs, float scale, bool vec, int max_smem,
                                        int sms, cudaStream_t stream);
cudaError_t attention_bf16_fwd_long(const bf16* q, const bf16* k, const bf16* v,
                                   const unsigned char* mask, bf16* out, int N, int H, int L,
                                   int dk, int rs, int hs, float scale, bool vec, int max_smem,
                                   cudaStream_t stream);
cudaError_t attention_bf16_bwd_long(const bf16* q, const bf16* k, const bf16* v,
                                    const unsigned char* mask, const bf16* dout, bf16* dq,
                                    bf16* dk_out, bf16* dv_out, int N, int H, int L, int dk,
                                    int rs, int hs, float scale, bool vec, int max_smem,
                                    cudaStream_t stream);

}  // namespace digat
