// The masked attention pair's bf16 register-row backward up to kResL = 64
// positions (the titles at L 32, the user tower at L 50), on the tensor
// cores: the resident kernel that msa_attention_bf16.cu's header note
// describes (msa_attention_bf16.cuh says what it replaces, what bounds it
// and how its rows, fragments and products are laid out). A file of its
// own, so that nvcc compiles its 16 instantiations beside the forward's, in
// parallel; msa_attention_bf16.cu's entry point reaches it through
// digat::attention_bf16_bwd_resident.

#include "msa_attention_bf16.cuh"

namespace {

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// SHORT: L <= kShortL, p and ds kept; else kShortL < L <= kResL, the
// statistics kept and the scores formed again in the column pass
template <int NT, bool EVEN, bool SHORT>
__global__ void __launch_bounds__(kRWarps * 32, kRMinBlocks)
msa_attention_bf16_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                              const bf16* __restrict__ dout, bf16* __restrict__ dq,
                              bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int units,
                              int stages, int H, int L, int dk, int rs, int hs, float scale,
                              bool vec) {
  constexpr int NKC = NT / 2;
  extern __shared__ float4 smem4[];
  const BGeom b = bgeom(SHORT ? kBShort : kBMid, L, H, hs, vec);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lp = b.qr, ps = lp + 8, sr = b.sr, plane = lp * ps;
  const Lane<NT, EVEN> ln(sr, dk);
  const size_t stage_bytes = 4 * size_t(lp) * 2 * sr + lp;
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  bf16* Gs = reinterpret_cast<bf16*>(smem + stages * stage_bytes);  // the staged dq [lp][sr]
  bf16* Pb = Gs + lp * sr;  // SHORT: [head][p hi, p lo, ds hi, ds lo][lp][ps], row i, key j
  float* Sm = reinterpret_cast<float*>(Pb);  // else [head][lp]: m, then 1 / sum, then t
  float* Si = Sm + b.g * lp;
  float* Stt = Si + b.g * lp;
  const bf16* const srcs[4] = {q, dout, k, v};
  auto issue = [&](int i) {
    const int unit = blockIdx.x + i * gridDim.x;
    if (unit < units) {
      const BPlace at = bplace(unit, b, H, L, rs, hs);
      issue_unit(vec, smem + (i % stages) * stage_bytes, srcs, mask, at, L, lp,
                 (at.gh - 1) * hs + dk, rs, sr);
    }
    cp_commit();
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);
  for (int i = 0; blockIdx.x + i * gridDim.x < units; ++i) {
    issue(i + stages - 1);
    cp_wait_n(stages - 1);
    __syncthreads();
    const BPlace at = bplace(blockIdx.x + i * gridDim.x, b, H, L, rs, hs);
    bf16* Qs = reinterpret_cast<bf16*>(smem + (i % stages) * stage_bytes);
    bf16* Ds = Qs + lp * sr;  // do
    bf16* Ks = Ds + lp * sr;  // k, then the staged dk
    bf16* Vs = Ks + lp * sr;  // v, then the staged dv
    const unsigned char* keep = reinterpret_cast<const unsigned char*>(Vs + lp * sr);
    const int tasks = at.gh * (lp / 16);
    // ---- row pass: a task per head and 16 query rows ----
    for (int task = warp; task < tasks; task += b.warps) {
      const int hh = task % at.gh, r0 = 16 * (task / at.gh);
      const bf16 *Kh = Ks + hh * hs, *Vh = Vs + hh * hs;
      uint32_t aq[NKC][4], ad[NKC][4];
      rows_frags(aq, Qs + hh * hs, r0, ln);
      rows_frags(ad, Ds + hh * hs, r0, ln);
      float acc[NT][4];
      zero_acc(acc);
      if constexpr (SHORT) {  // all keys in one tile: each score formed once
        float s[4][4], dp[4][4];
        scores<4>(s, aq, Kh, 0, ln);
        scores<4>(dp, ad, Vh, 0, ln);
        uint32_t live_k, kept_k;
        key_bits(keep, 0, L, lane, live_k, kept_k);
        mask_tile<4>(s, live_k, kept_k, scale, t);
        zero_dead<4>(dp, live_k, t);
        float inv[2], tr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) x = fmaxf(x, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
          x = quad_max(x);  // finite: key 0 is before L
          float sum = 0.f, tu = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[nt][e] = expf(s[nt][e] - x);
              sum += s[nt][e];
              tu = fmaf(s[nt][e], dp[nt][e], tu);
            }
          inv[r] = 1.f / quad_sum(sum);
          tr[r] = quad_sum(tu) * inv[r];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = 8 * nt + 2 * t + (e & 1);
            const float p = s[nt][e] * inv[r];
            dp[nt][e] = (kept_k >> key) & 1u ? p * (dp[nt][e] - tr[r]) * scale : 0.f;  // ds
            s[nt][e] = p;
          }
        Split pf, df;
        split_tile<4>(pf, s);
        split_tile<4>(df, dp);
        values<false>(acc, df, Kh, 0, L, 1.f, 1.f, ln);  // dq = ds k
        bf16* P = Pb + hh * 4 * plane;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          if (16 * ch < lp) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {  // A fragment u: rows g + 8 (u & 1), keys + 8 (u >> 1)
              const int ij = (r0 + g + 8 * (u & 1)) * ps + 16 * ch + 8 * (u >> 1) + 2 * t;
              *reinterpret_cast<uint32_t*>(P + ij) = pf.hi[ch][u];
              *reinterpret_cast<uint32_t*>(P + plane + ij) = pf.lo[ch][u];
              *reinterpret_cast<uint32_t*>(P + 2 * plane + ij) = df.hi[ch][u];
              *reinterpret_cast<uint32_t*>(P + 3 * plane + ij) = df.lo[ch][u];
            }
          }
        }
      } else {  // two 32-key tiles: the statistics online, then dq
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tu[2] = {0.f, 0.f};
        for (int j0 = 0; j0 < L; j0 += kKT) {
          float s[4][4], dp[4][4];
          scores<4>(s, aq, Kh, j0, ln);
          scores<4>(dp, ad, Vh, j0, ln);
          uint32_t live_k, kept_k;
          key_bits(keep + j0, j0, L, lane, live_k, kept_k);
          mask_tile<4>(s, live_k, kept_k, scale, t);
          zero_dead<4>(dp, live_k, t);
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
        float inv[2], tr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv[r] = 1.f / quad_sum(l[r]);
          tr[r] = quad_sum(tu[r]) * inv[r];
          const int row = r0 + g + 8 * r;
          if (t == 0) {  // rows past L: 0, so that their p is 0
            Sm[hh * lp + row] = row < L ? m[r] : 0.f;
            Si[hh * lp + row] = row < L ? inv[r] : 0.f;
            Stt[hh * lp + row] = row < L ? tr[r] : 0.f;
          }
        }
        for (int j0 = 0; j0 < L; j0 += kKT) {
          float s[4][4], dp[4][4];
          scores<4>(s, aq, Kh, j0, ln);
          scores<4>(dp, ad, Vh, j0, ln);
          uint32_t live_k, kept_k;
          key_bits(keep + j0, j0, L, lane, live_k, kept_k);
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
          values<false>(acc, df, Kh, j0, L - j0, 1.f, 1.f, ln);  // dq += ds k
        }
      }
      stage_rows(Gs + hh * hs, acc, 1.f, 1.f, r0, hs, ln);
    }
    __syncthreads();
    // ---- column pass: a task per head and 16 keys ----
    for (int task = warp; task < tasks; task += b.warps) {
      const int hh = task % at.gh, j0 = 16 * (task / at.gh);
      const bf16 *Qh = Qs + hh * hs, *Dh = Ds + hh * hs;
      float gk[NT][4], gv[NT][4];
      zero_acc(gk);
      zero_acc(gv);
      if constexpr (SHORT) {
        const bf16* P = Pb + hh * 4 * plane;
        const int mi = lane >> 3, ri = lane & 7;
        for (int ic = 0; ic < lp / 16; ++ic) {
          // A = p^T, ds^T (16 keys x 16 rows) by ldmatrix.trans of [i][j]
          const int off = (16 * ic + 8 * (mi >> 1) + ri) * ps + j0 + 8 * (mi & 1);
          uint32_t ph[4], pl[4], dh[4], dl[4];
          ldsm4_trans(ph, P + off);
          ldsm4_trans(pl, P + plane + off);
          ldsm4_trans(dh, P + 2 * plane + off);
          ldsm4_trans(dl, P + 3 * plane + off);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (8 * nt < dk) {
              uint32_t bq[2], bd[2];
              frag_b_cols(bq, Qh, 16 * ic, nt, ln);
              frag_b_cols(bd, Dh, 16 * ic, nt, ln);
              mma_bf16(gk[nt], dl, bq);
              mma_bf16(gk[nt], dh, bq);
              mma_bf16(gv[nt], pl, bd);
              mma_bf16(gv[nt], ph, bd);
            }
          }
        }
      } else {
        uint32_t ak[NKC][4], av[NKC][4];
        rows_frags(ak, Ks + hh * hs, j0, ln);
        rows_frags(av, Vs + hh * hs, j0, ln);
        const bool kept[2] = {keep[j0 + g] != 0, keep[j0 + g + 8] != 0};
        for (int i0 = 0; i0 < L; i0 += kKT) {  // 32-row tiles
          float s[4][4], dp[4][4];
          scores<4>(s, ak, Qh, i0, ln);   // s^T: rows the keys
          scores<4>(dp, av, Dh, i0, ln);  // dp^T
          const float* sm = Sm + hh * lp;
          const float* si = Si + hh * lp;
          const float* st = Stt + hh * lp;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, i = i0 + 8 * nt + 2 * t + (e & 1);
              const bool row = i < L;  // rows past L: p 0
              const float x = kept[r] ? s[nt][e] * scale : kMaskFill;
              const float p = row ? expf(x - sm[i]) * si[i] : 0.f;
              dp[nt][e] = kept[r] && row ? p * (dp[nt][e] - st[i]) * scale : 0.f;  // ds
              s[nt][e] = p;
            }
          Split pf, df;
          split_tile<4>(pf, s);
          split_tile<4>(df, dp);
          values<false>(gv, pf, Dh, i0, L - i0, 1.f, 1.f, ln);
          values<false>(gk, df, Qh, i0, L - i0, 1.f, 1.f, ln);
        }
      }
      // the task's k and v rows are read (or unread, SHORT): dk and dv staged over them
      stage_rows(Ks + hh * hs, gk, 1.f, 1.f, j0, hs, ln);
      stage_rows(Vs + hh * hs, gv, 1.f, 1.f, j0, hs, ln);
    }
    __syncthreads();
    bf16* const outs[3] = {dq, dk_out, dv_out};
    const bf16* const staged[3] = {Gs, Ks, Vs};
    store_spans<3>(vec, outs, at.base, staged, L, at.gh * hs, rs, sr, threadIdx.x, blockDim.x);
    __syncthreads();  // the stage and the staged dq are rewritten next
  }
}

using BBwdKernel = void (*)(const bf16*, const bf16*, const bf16*, const unsigned char*,
                            const bf16*, bf16*, bf16*, bf16*, int, int, int, int, int, int, int,
                            float, bool);

template <bool EVEN, bool SHORT>
BBwdKernel bf16_bwd_kernel(int nt) {
  switch (nt) {
    case 2: return msa_attention_bf16_bwd_kernel<2, EVEN, SHORT>;
    case 4: return msa_attention_bf16_bwd_kernel<4, EVEN, SHORT>;
    case 6: return msa_attention_bf16_bwd_kernel<6, EVEN, SHORT>;
    case 8: return msa_attention_bf16_bwd_kernel<8, EVEN, SHORT>;
    default: return nullptr;
  }
}

}  // namespace

namespace digat {

cudaError_t attention_bf16_bwd_init(int max_smem) {
  cudaError_t e = cudaSuccess;
  for (int nt = 2; nt <= 8 && e == cudaSuccess; nt += 2) {
    const void* kernels[] = {reinterpret_cast<const void*>(bf16_bwd_kernel<false, true>(nt)),
                             reinterpret_cast<const void*>(bf16_bwd_kernel<true, true>(nt)),
                             reinterpret_cast<const void*>(bf16_bwd_kernel<false, false>(nt)),
                             reinterpret_cast<const void*>(bf16_bwd_kernel<true, false>(nt))};
    for (const void* kern : kernels) {
      if (e == cudaSuccess) e = allow_bf16_smem(kern, max_smem);
    }
  }
  return e;
}

cudaError_t attention_bf16_bwd_resident(const bf16* q, const bf16* k, const bf16* v,
                                        const unsigned char* mask, const bf16* dout, bf16* dq,
                                        bf16* dk_out, bf16* dv_out, int N, int H, int L, int dk,
                                        int rs, int hs, float scale, bool vec, int max_smem,
                                        int sms, cudaStream_t stream) {
  const bool shrt = L <= kShortL;
  const int kind = shrt ? kBShort : kBMid;
  const BGeom b = bgeom(kind, L, H, hs, vec);
  const long long units = static_cast<long long>(N) * b.groups;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  const int nt = round_up(dk, 16) / 8;
  const BBwdKernel kern = hs % 2 ? (shrt ? bf16_bwd_kernel<false, true>(nt)
                                         : bf16_bwd_kernel<false, false>(nt))
                                  : (shrt ? bf16_bwd_kernel<true, true>(nt)
                                          : bf16_bwd_kernel<true, false>(nt));
  int blocks = 0, stages = 0;
  size_t smem = 0;
  resident_plan(kern, kind, L, b, static_cast<int>(units), max_smem, sms, blocks, stages, smem);
  if (blocks == 0) return cudaErrorInvalidValue;
  kern<<<blocks, 32 * b.warps, smem, stream>>>(q, k, v, mask, dout, dq, dk_out, dv_out,
                                               static_cast<int>(units), stages, H, L, dk, rs, hs,
                                               scale, vec);
  return cudaGetLastError();
}

}  // namespace digat
