// The masked attention pair's bf16 register-row kernels past kResL = 64
// positions (MSA titles at L 160), forward and backward, on the tensor
// cores (msa_attention_bf16.cuh says what they replace, what bounds them
// and how their rows, fragments and products are laid out). A file of its
// own, so that nvcc compiles it beside msa_attention_bf16.cu, in parallel;
// that file's entry points reach it through digat::attention_bf16_fwd_long
// and digat::attention_bf16_bwd_long.
//
// The backward is one launch. A block owns a group of g heads of one
// sequence; its warps each own a head and 16 rows of a chunk of qr own
// rows, and the other side's rows stream through shared memory in tiles of
// kKT = 32, double-buffered. The forward saved nothing, so the row
// statistics are recomputed, as JAX's F recomputes them; they stay in
// shared memory, so no pass writes to device memory what another reads
// back.
//   1. rows, statistics: per chunk of query rows, over the key tiles, s and
//      dp = do v^T with the row max m, the sum and sum_j e dp online; m,
//      1 / sum and t per head and row into shared memory;
//   2. rows, dq: over the key tiles again, s, dp, ds = keep ? p (dp - t)
//      scale : 0 and dq += ds k; staged over the chunk's q rows and stored;
//   3. columns, after a block barrier: per chunk of keys, over the query
//      tiles with their rows' statistics, s^T, dp^T, p and ds, dv += p^T do
//      and dk += ds^T q; staged over the chunk's k and v rows and stored.
// s and dp are formed three times a pair. Shared memory grows with L only
// by the statistics (12 g bytes a row) and the mask (a byte a row), which
// caps L (ops/msa_attention.py's `max_length`).

#include "msa_attention_bf16.cuh"

namespace {

// The forward past kResL: a block owns the query rows [i0, i0 + qr) of a
// group of one sequence, a warp a head and 32 rows (two m16 tiles against
// each key fragment, as the resident forward's tasks); q's rows are copied
// once, k and v stream through two stages of kKT keys, the next tile's copy
// issued before this one's products. Per tile as the resident forward.
template <int NT, bool EVEN>
__global__ void __launch_bounds__(kBWarps * 32, kFwdLongMinBlocks)
msa_attention_bf16_fwd_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const unsigned char* __restrict__ mask, bf16* __restrict__ out,
                                   int H, int L, int dk, int rs, int hs, float scale, bool vec) {
  constexpr int NKC = NT / 2;
  extern __shared__ float4 smem4[];
  const BGeom b = bgeom(kBFwdLong, L, H, hs, vec);
  const int chunks = (L + b.qr - 1) / b.qr;
  const int chunk = blockIdx.x % chunks;
  const BPlace at = bplace(blockIdx.x / chunks, b, H, L, rs, hs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int hh = warp % b.g, r0 = 32 * (warp / b.g);  // the warp's head and first own row
  const int i0 = chunk * b.qr, own = min(b.qr, L - i0), sr = b.sr;
  const Lane<NT, EVEN> ln(sr, dk);
  const bool active = hh < at.gh && r0 < own;  // else the warp only copies
  const bool two = r0 + 16 < own;  // else the second tile repeats the first, unstaged
  const int width = (at.gh - 1) * hs + dk;  // elements of a row that the heads read
  const int ntiles = (L + kKT - 1) / kKT;
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [qr][sr], then the staged out
  bf16* stream = Qs + b.qr * sr;              // [stage][k, v][kKT][sr]
  unsigned char* keep = reinterpret_cast<unsigned char*>(stream + 2 * 2 * kKT * sr);
  const bf16* const qsrc[1] = {q};
  load_spans<1>(vec, Qs, 0, qsrc, at.base + size_t(i0) * rs, own, b.qr, width, rs, sr,
                threadIdx.x, blockDim.x);
  auto fetch = [&](int jt) {
    bf16* st = stream + (jt & 1) * 2 * kKT * sr;
    const int j0 = jt * kKT, rows = min(kKT, L - j0);
    const bf16* const kv[2] = {k, v};
    load_spans<2>(vec, st, kKT * sr, kv, at.base + size_t(j0) * rs, rows, kKT, width, rs, sr,
                  threadIdx.x, blockDim.x);
    for (int j = threadIdx.x; j < kKT; j += blockDim.x)
      keep[(jt & 1) * kKT + j] =
          j < rows && (mask == nullptr || mask[size_t(at.n) * L + j0 + j]);
    cp_commit();
  };
  fetch(0);
  bf16* Qh = Qs + hh * hs;
  float o[2][NT][4];
  zero_acc(o[0]);
  zero_acc(o[1]);
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  uint32_t a[2][NKC][4];
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) {
      fetch(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (jt == 0) {
        rows_frags(a[0], Qh, r0, ln);
        rows_frags(a[1], Qh, two ? r0 + 16 : r0, ln);
      }
      const bf16* Ks = stream + (jt & 1) * 2 * kKT * sr + hh * hs;
      float s[2][4][4];
      scores2(s, a, Ks, 0, ln);
      uint32_t live_k, kept_k;
      key_bits(keep + (jt & 1) * kKT, jt * kKT, L, lane, live_k, kept_k);
      Split p[2];
      float corr[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mask_tile<4>(s[mt], live_k, kept_k, scale, t);
        online_step(s[mt], m[mt], l[mt], corr[mt]);
        split_tile<4>(p[mt], s[mt]);
      }
      values2<true>(o, p, Ks + kKT * sr, 0, L - jt * kKT, corr, ln);
    }
    __syncthreads();  // the stage is refilled next
  }
  // q's rows are in registers: the warp stages its rows of out over them
  if (active) {
    stage_rows(Qh, o[0], 1.f / quad_sum(l[0][0]), 1.f / quad_sum(l[0][1]), r0, hs, ln);
    if (two)
      stage_rows(Qh, o[1], 1.f / quad_sum(l[1][0]), 1.f / quad_sum(l[1][1]), r0 + 16, hs, ln);
  }
  __syncthreads();
  bf16* const outs[1] = {out};
  const bf16* const staged[1] = {Qs};
  store_spans<1>(vec, outs, at.base + size_t(i0) * rs, staged, own, at.gh * hs, rs, sr,
                 threadIdx.x, blockDim.x);
}

template <int NT, bool EVEN>
__global__ void __launch_bounds__(kBWarps * 32, 1)
msa_attention_bf16_bwd_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const unsigned char* __restrict__ mask,
                                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                   bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int H,
                                   int L, int dk, int rs, int hs, float scale, bool vec) {
  constexpr int NKC = NT / 2;
  extern __shared__ float4 smem4[];
  const BGeom b = bgeom(kBLong, L, H, hs, vec);
  const BPlace at = bplace(blockIdx.x, b, H, L, rs, hs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hh = warp % b.g, r0 = 16 * (warp / b.g);  // the warp's head and first own row
  const int qr = b.qr, sr = b.sr, lr = round_up(L, kKT);
  const Lane<NT, EVEN> ln(sr, dk);
  const bool alive = hh < at.gh;
  const int width = (at.gh - 1) * hs + dk;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int chunks = (L + qr - 1) / qr, ntiles = (L + kKT - 1) / kKT;
  bf16* Oa = reinterpret_cast<bf16*>(smem4);  // own rows [qr][sr]: q, then k; staged dq, dk
  bf16* Ob = Oa + qr * sr;                    // do, then v; staged dv
  bf16* stream = Ob + qr * sr;                // [stage][2][kKT][sr]
  float* Sm = reinterpret_cast<float*>(stream + 2 * 2 * kKT * sr);  // [g][lr]: m
  float* Si = Sm + b.g * lr;                                         // 1 / sum
  float* Stt = Si + b.g * lr;                                        // t
  unsigned char* keep = reinterpret_cast<unsigned char*>(Stt + b.g * lr);  // [lr]
  for (int j = tid; j < 3 * b.g * lr; j += threads) Sm[j] = 0.f;  // rows past L: p = 0
  for (int j = tid; j < lr; j += threads)
    keep[j] = j < L && (mask == nullptr || mask[size_t(at.n) * L + j]);
  auto fetch = [&](const bf16* A, const bf16* B, int jt) {
    bf16* st = stream + (jt & 1) * 2 * kKT * sr;
    const int j0 = jt * kKT, rows = min(kKT, L - j0);
    const bf16* const ab[2] = {A, B};
    load_spans<2>(vec, st, kKT * sr, ab, at.base + size_t(j0) * rs, rows, kKT, width, rs, sr, tid,
                  threads);
    cp_commit();
  };
  auto next = [&](const bf16* A, const bf16* B, int jt) {
    if (jt + 1 < ntiles) {
      fetch(A, B, jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
  };
  // ---- rows: the statistics, then dq ----
  for (int c = 0; c < chunks; ++c) {
    const int i0 = c * qr, own = min(qr, L - i0);
    const bool active = alive && r0 < own;
    const bf16* const qd[2] = {q, dout};
    load_spans<2>(vec, Oa, qr * sr, qd, at.base + size_t(i0) * rs, own, qr, width, rs, sr, tid,
                  threads);
    uint32_t aq[NKC][4], ad[NKC][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tu[2] = {0.f, 0.f};
    fetch(k, v, 0);
    for (int jt = 0; jt < ntiles; ++jt) {
      next(k, v, jt);
      if (active) {
        if (jt == 0) {
          rows_frags(aq, Oa + hh * hs, r0, ln);
          rows_frags(ad, Ob + hh * hs, r0, ln);
        }
        const bf16* Ks = stream + (jt & 1) * 2 * kKT * sr + hh * hs;
        const int live = min(kKT, L - jt * kKT);
        float s[4][4], dp[4][4];
        scores<4>(s, aq, Ks, 0, ln);
        scores<4>(dp, ad, Ks + kKT * sr, 0, ln);
        uint32_t live_k, kept_k;
        key_bits(keep + jt * kKT, jt * kKT, L, lane, live_k, kept_k);
        mask_tile<4>(s, live_k, kept_k, scale, t);
        float corr[2];
        online_step(s, m, l, corr);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float part = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) part = fmaf(s[nt][e], dp[nt][e], part);
          tu[r] = fmaf(tu[r], corr[r], part);
        }
      }
      __syncthreads();  // the stage is refilled next
    }
    float inv[2] = {0.f, 0.f}, tr[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv[r] = 1.f / quad_sum(l[r]);
        tr[r] = quad_sum(tu[r]) * inv[r];
        const int row = i0 + r0 + g + 8 * r;
        if (t == 0 && row < L) {
          Sm[hh * lr + row] = m[r];
          Si[hh * lr + row] = inv[r];
          Stt[hh * lr + row] = tr[r];
        }
      }
    }
    float acc[NT][4];
    zero_acc(acc);
    fetch(k, v, 0);
    for (int jt = 0; jt < ntiles; ++jt) {
      next(k, v, jt);
      if (active) {
        const bf16* Ks = stream + (jt & 1) * 2 * kKT * sr + hh * hs;
        const int live = min(kKT, L - jt * kKT);
        float s[4][4], dp[4][4];
        scores<4>(s, aq, Ks, 0, ln);
        scores<4>(dp, ad, Ks + kKT * sr, 0, ln);
        uint32_t live_k, kept_k;
        key_bits(keep + jt * kKT, jt * kKT, L, lane, live_k, kept_k);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = 8 * nt + 2 * t + (e & 1);
            const float p = expf(s[nt][e] * scale - m[r]) * inv[r];
            dp[nt][e] = (kept_k >> key) & 1u ? p * (dp[nt][e] - tr[r]) * scale : 0.f;  // ds
          }
        Split df;
        split_tile<4>(df, dp);
        values<false>(acc, df, Ks, 0, live, 1.f, 1.f, ln);
      }
      __syncthreads();
    }
    // q's rows are in registers: the warp stages its rows of dq over them
    if (active) stage_rows(Oa + hh * hs, acc, 1.f, 1.f, r0, hs, ln);
    __syncthreads();
    bf16* const gq[1] = {dq};
    const bf16* const staged[1] = {Oa};
    store_spans<1>(vec, gq, at.base + size_t(i0) * rs, staged, own, at.gh * hs, rs, sr, tid,
                   threads);
    __syncthreads();  // the own rows are refilled next
  }
  // ---- columns: dk and dv over the query tiles ----
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * qr, own = min(qr, L - j0);
    const bool active = alive && r0 < own;
    const bf16* const kv[2] = {k, v};
    load_spans<2>(vec, Oa, qr * sr, kv, at.base + size_t(j0) * rs, own, qr, width, rs, sr, tid,
                  threads);
    uint32_t ak[NKC][4], av[NKC][4];
    bool kept[2] = {false, false};
    float gk[NT][4], gv[NT][4];
    zero_acc(gk);
    zero_acc(gv);
    fetch(q, dout, 0);
    for (int it = 0; it < ntiles; ++it) {
      next(q, dout, it);
      if (active) {
        if (it == 0) {
          rows_frags(ak, Oa + hh * hs, r0, ln);
          rows_frags(av, Ob + hh * hs, r0, ln);
          kept[0] = keep[j0 + r0 + g];
          kept[1] = keep[j0 + r0 + g + 8];
        }
        const bf16* Qt = stream + (it & 1) * 2 * kKT * sr + hh * hs;
        const bf16* Dt = Qt + kKT * sr;
        const int live = min(kKT, L - it * kKT), row0 = hh * lr + it * kKT;
        float s[4][4], dp[4][4];
        scores<4>(s, ak, Qt, 0, ln);   // s^T: rows the warp's keys
        scores<4>(dp, av, Dt, 0, ln);  // dp^T
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = row0 + 8 * nt + 2 * t + (e & 1);
            const float x = kept[r] ? s[nt][e] * scale : kMaskFill;
            const float p = expf(x - Sm[i]) * Si[i];
            dp[nt][e] = kept[r] ? p * (dp[nt][e] - Stt[i]) * scale : 0.f;  // ds
            s[nt][e] = p;
          }
        Split pf, df;
        split_tile<4>(pf, s);
        split_tile<4>(df, dp);
        values<false>(gv, pf, Dt, 0, live, 1.f, 1.f, ln);
        values<false>(gk, df, Qt, 0, live, 1.f, 1.f, ln);
      }
      __syncthreads();
    }
    if (active) {
      stage_rows(Oa + hh * hs, gk, 1.f, 1.f, r0, hs, ln);
      stage_rows(Ob + hh * hs, gv, 1.f, 1.f, r0, hs, ln);
    }
    __syncthreads();
    bf16* const gkv[2] = {dk_out, dv_out};
    const bf16* const staged[2] = {Oa, Ob};
    store_spans<2>(vec, gkv, at.base + size_t(j0) * rs, staged, own, at.gh * hs, rs, sr, tid,
                   threads);
    __syncthreads();
  }
}

using BFwdLongKernel = void (*)(const bf16*, const bf16*, const bf16*, const unsigned char*,
                                bf16*, int, int, int, int, int, float, bool);
using BLongKernel = void (*)(const bf16*, const bf16*, const bf16*, const unsigned char*,
                             const bf16*, bf16*, bf16*, bf16*, int, int, int, int, int, float,
                             bool);

template <bool EVEN>
BFwdLongKernel bf16_fwd_long_kernel(int nt) {
  switch (nt) {
    case 2: return msa_attention_bf16_fwd_long_kernel<2, EVEN>;
    case 4: return msa_attention_bf16_fwd_long_kernel<4, EVEN>;
    case 6: return msa_attention_bf16_fwd_long_kernel<6, EVEN>;
    case 8: return msa_attention_bf16_fwd_long_kernel<8, EVEN>;
    default: return nullptr;
  }
}

template <bool EVEN>
BLongKernel bf16_long_kernel(int nt) {
  switch (nt) {
    case 2: return msa_attention_bf16_bwd_long_kernel<2, EVEN>;
    case 4: return msa_attention_bf16_bwd_long_kernel<4, EVEN>;
    case 6: return msa_attention_bf16_bwd_long_kernel<6, EVEN>;
    case 8: return msa_attention_bf16_bwd_long_kernel<8, EVEN>;
    default: return nullptr;
  }
}

}  // namespace

namespace digat {

cudaError_t attention_bf16_long_init(int max_smem) {
  cudaError_t e = cudaSuccess;
  for (int nt = 2; nt <= 8 && e == cudaSuccess; nt += 2) {
    e = allow_bf16_smem(bf16_long_kernel<false>(nt), max_smem);
    if (e == cudaSuccess) e = allow_bf16_smem(bf16_long_kernel<true>(nt), max_smem);
    if (e == cudaSuccess) e = allow_bf16_smem(bf16_fwd_long_kernel<false>(nt), max_smem);
    if (e == cudaSuccess) e = allow_bf16_smem(bf16_fwd_long_kernel<true>(nt), max_smem);
  }
  return e;
}

cudaError_t attention_bf16_fwd_long(const bf16* q, const bf16* k, const bf16* v,
                                   const unsigned char* mask, bf16* out, int N, int H, int L,
                                   int dk, int rs, int hs, float scale, bool vec, int max_smem,
                                   cudaStream_t stream) {
  const BGeom b = bgeom(kBFwdLong, L, H, hs, vec);
  const size_t smem = bf16_smem(kBFwdLong, L, b, 1);
  const long long blocks = static_cast<long long>(N) * b.groups * ((L + b.qr - 1) / b.qr);
  if (smem > size_t(max_smem) || blocks > INT_MAX) return cudaErrorInvalidValue;
  const int nt = round_up(dk, 16) / 8;
  const BFwdLongKernel kern =
      hs % 2 ? bf16_fwd_long_kernel<false>(nt) : bf16_fwd_long_kernel<true>(nt);
  kern<<<static_cast<int>(blocks), 32 * b.warps, smem, stream>>>(q, k, v, mask, out, H, L, dk, rs,
                                                                 hs, scale, vec);
  return cudaGetLastError();
}

cudaError_t attention_bf16_bwd_long(const bf16* q, const bf16* k, const bf16* v,
                                    const unsigned char* mask, const bf16* dout, bf16* dq,
                                    bf16* dk_out, bf16* dv_out, int N, int H, int L, int dk,
                                    int rs, int hs, float scale, bool vec, int max_smem,
                                    cudaStream_t stream) {
  const BGeom b = bgeom(kBLong, L, H, hs, vec);
  const size_t smem = bf16_smem(kBLong, L, b, 1);
  const long long blocks = static_cast<long long>(N) * b.groups;
  if (smem > size_t(max_smem) || blocks > INT_MAX) return cudaErrorInvalidValue;
  const int nt = round_up(dk, 16) / 8;
  const BLongKernel kern = hs % 2 ? bf16_long_kernel<false>(nt) : bf16_long_kernel<true>(nt);
  kern<<<static_cast<int>(blocks), 32 * b.warps, smem, stream>>>(q, k, v, mask, dout, dq, dk_out,
                                                                 dv_out, H, L, dk, rs, hs, scale,
                                                                 vec);
  return cudaGetLastError();
}

}  // namespace digat
