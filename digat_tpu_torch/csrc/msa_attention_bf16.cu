// The masked attention pair's bf16 instances (compute_dtype bfloat16) and
// their C entry points: q, k, v, do and every output bf16, the arithmetic
// fp32, each output rounded once to nearest even. Heads of dk <= 64 run the
// register-row instance's own kernels, on the tensor cores
// (msa_attention_bf16.cuh says what they replace, what bounds them and how
// they are laid out): here the resident forward, L <= kResL = 64, and the
// notes on the resident kernels; the resident backward is
// msa_attention_bf16_bwd.cu, the streamed kernels past kResL
// msa_attention_bf16_long.cu. Heads of dk 65-128 run the wide instance
// (msa_attention_wide.cu).
//
// Resident kernels. A unit is a group of g heads of one sequence, its rows
// whole (L rounded up to 16: lp). A block walks over units blockIdx.x,
// blockIdx.x + gridDim.x, ... with the copies of up to kStages units in
// flight (a stage each, by cp.async; the grid as many blocks as are
// resident on the card), so that bytes keep arriving while it computes: a
// short-lived block a unit would hold too few bytes in flight to feed HBM.
// A task is a head and 16 rows (one m16 tile); the block's warps take the
// unit's tasks in turn, and the outputs are staged in shared memory, then
// stored as 16-byte rows of the group.
//  * Forward: per task, over the keys in tiles of kKT = 32, the scores (the
//    task's q fragments in registers), the mask, an online-softmax step
//    with the row max and sum reduced across each quad, and p v, the
//    accumulator rescaled; out = o / sum, staged over the task's q rows.
//  * Backward, L <= kShortL (the titles): each score and each dp formed
//    once. Row pass, a task per head and 16 query rows: s = q k^T and dp =
//    do v^T over all keys, the row max, 1 / sum and t = sum_j p dp in
//    registers, p and ds = keep ? p (dp - t) scale : 0 into shared memory
//    as bf16 hi and lo ([lp][lp + 8] a head and array, read back by
//    ldmatrix.trans), and dq = ds k from the registers, staged. After a
//    block barrier, the column pass, a task per head and 16 keys: dk = ds^T
//    q and dv = p^T do, staged where k and v were.
//  * Backward, kShortL < L <= kResL (the user tower at L 50): per task of a
//    head and 16 query rows, the row max, sum and t online over the two
//    32-key tiles, then the tiles again for ds and dq (each tile's part
//    added rounding to nearest), m, 1 / sum and t per head and row left in
//    shared memory; after a block barrier the column pass forms s^T and
//    dp^T again, a task per head and 16 keys over 32-row tiles, for dk and
//    dv. (Holding the 64 keys' s and dp in registers, to form them once,
//    took 255 registers a thread and ran 2.4 times slower at the user
//    tower; p and ds in shared memory would take 37 KB a head at L 64.)
//
// What the measurements showed (H100, the titles [6,720, 32, 20 x 20]): the
// kernels issue instructions, not bytes, at these widths; a fragment's
// load, its mask and its address are most of them. So each lane's columns,
// masks and row offsets are computed once a launch (`Lane`), the products'
// tile loops have no branches, a forward task takes 32 rows so that each
// key fragment feeds two m16 tiles, the masks are two ballots a tile, and
// the copies of all operands share one (row, chunk) step.

#include "msa_attention_bf16.cuh"

namespace {

int g_max_smem_bf16 = 0;  // opt-in shared memory per block, set by init
int g_sms = 0;            // SMs of the device

// NT: 8-column tiles of dk padded to 16 (2, 4, 6, 8); EVEN: hs even (Lane);
// vec: 16-byte copies
template <int NT, bool EVEN>
__global__ void __launch_bounds__(kRWarps * 32, kRMinBlocks)
msa_attention_bf16_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                              bf16* __restrict__ out, int units, int stages, int H, int L, int dk,
                              int rs, int hs, float scale, bool vec) {
  constexpr int NKC = NT / 2;
  extern __shared__ float4 smem4[];
  const BGeom b = bgeom(kBFwd, L, H, hs, vec);
  const int lp = b.qr, sr = b.sr;
  const Lane<NT, EVEN> ln(sr, dk);
  const size_t stage_bytes = 3 * size_t(lp) * 2 * sr + lp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const bf16* const srcs[3] = {q, k, v};
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
    issue(i + stages - 1);  // into the stage of unit i - 1, stored before the last barrier
    cp_wait_n(stages - 1);
    __syncthreads();
    const BPlace at = bplace(blockIdx.x + i * gridDim.x, b, H, L, rs, hs);
    bf16* Qs = reinterpret_cast<bf16*>(smem + (i % stages) * stage_bytes);  // then the staged out
    const bf16* Ks = Qs + lp * sr;
    const bf16* Vs = Ks + lp * sr;
    const unsigned char* keep = reinterpret_cast<const unsigned char*>(Vs + lp * sr);
    const int tasks = at.gh * ((lp + 31) / 32);
    for (int task = warp; task < tasks; task += b.warps) {  // a head and 32 rows
      const int hh = task % at.gh, r0 = 32 * (task / at.gh);
      const bool two = r0 + 16 < lp;  // else the second tile repeats the first, unstaged
      bf16* Qh = Qs + hh * hs;
      const bf16 *Kh = Ks + hh * hs, *Vh = Vs + hh * hs;
      uint32_t a[2][NKC][4];
      rows_frags(a[0], Qh, r0, ln);
      rows_frags(a[1], Qh, two ? r0 + 16 : r0, ln);
      float o[2][NT][4];
      zero_acc(o[0]);
      zero_acc(o[1]);
      float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
      float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int j0 = 0; j0 < L; j0 += kKT) {
        float s[2][4][4];
        scores2(s, a, Kh, j0, ln);
        uint32_t live_k, kept_k;
        key_bits(keep + j0, j0, L, lane, live_k, kept_k);
        Split p[2];
        float corr[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mask_tile<4>(s[mt], live_k, kept_k, scale, t);
          online_step(s[mt], m[mt], l[mt], corr[mt]);
          split_tile<4>(p[mt], s[mt]);
        }
        values2<true>(o, p, Vh, j0, L - j0, corr, ln);
      }
      // the task's q rows are in registers: its rows of out are staged over them
      stage_rows(Qh, o[0], 1.f / quad_sum(l[0][0]), 1.f / quad_sum(l[0][1]), r0, hs, ln);
      if (two)
        stage_rows(Qh, o[1], 1.f / quad_sum(l[1][0]), 1.f / quad_sum(l[1][1]), r0 + 16, hs, ln);
    }
    __syncthreads();
    bf16* const outs[1] = {out};
    const bf16* const staged[1] = {Qs};
    store_spans<1>(vec, outs, at.base, staged, L, at.gh * hs, rs, sr, threadIdx.x, blockDim.x);
    __syncthreads();  // the stage is refilled next
  }
}

using BFwdKernel = void (*)(const bf16*, const bf16*, const bf16*, const unsigned char*, bf16*,
                            int, int, int, int, int, int, int, float, bool);

template <bool EVEN>
BFwdKernel bf16_fwd_kernel(int nt) {
  switch (nt) {
    case 2: return msa_attention_bf16_fwd_kernel<2, EVEN>;
    case 4: return msa_attention_bf16_fwd_kernel<4, EVEN>;
    case 6: return msa_attention_bf16_fwd_kernel<6, EVEN>;
    case 8: return msa_attention_bf16_fwd_kernel<8, EVEN>;
    default: return nullptr;
  }
}

bool bad_geometry_bf16(int N, int H, int L, int dk, int rs, int hs) {
  return N <= 0 || H <= 0 || L <= 0 || dk <= 0 || dk > kWide || hs < dk || rs < H * hs ||
         size_t(N) * H > size_t(INT_MAX);
}

// 16-byte copies: the row stride a multiple of 8 elements and every
// pointer 16-byte aligned (ops/msa_attention.py's `launch_plan`)
bool copies16(const void* const* ptrs, int count, int rs) {
  bool ok = rs % 8 == 0;
  for (int a = 0; a < count; ++a) ok = ok && reinterpret_cast<uintptr_t>(ptrs[a]) % 16 == 0;
  return ok;
}

// the wide instance's rule: rows of four-element groups
bool wide_vec(const void* const* ptrs, int count, int rs, int hs) {
  bool ok = rs % 4 == 0 && hs % 4 == 0;
  for (int a = 0; a < count; ++a) ok = ok && reinterpret_cast<uintptr_t>(ptrs[a]) % 8 == 0;
  return ok;
}

}  // namespace

extern "C" int msa_attention_bf16_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&g_max_smem_bf16, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  for (int nt = 2; nt <= 8 && e == cudaSuccess; nt += 2) {
    const void* kernels[] = {reinterpret_cast<const void*>(bf16_fwd_kernel<false>(nt)),
                             reinterpret_cast<const void*>(bf16_fwd_kernel<true>(nt))};
    for (const void* kern : kernels) {
      if (e == cudaSuccess) e = allow_bf16_smem(kern, g_max_smem_bf16);
    }
  }
  if (e == cudaSuccess) e = digat::attention_bf16_bwd_init(g_max_smem_bf16);
  if (e == cudaSuccess) e = digat::attention_bf16_long_init(g_max_smem_bf16);
  if (e == cudaSuccess) e = digat::attention_wide_init<bf16>(g_max_smem_bf16);
  return static_cast<int>(e);
}

// out [N, L, rs] from q, k, v [N, L, rs] (bf16) and the optional key mask
// [N, L] (bytes, nonzero = keep; null = keep all).
extern "C" int msa_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int N, int H, int L, int dk,
                                      int rs, int hs, float scale, void* stream) {
  if (bad_geometry_bf16(N, H, L, dk, rs, hs)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, out};
  const bf16 *pq = static_cast<const bf16*>(q), *pk = static_cast<const bf16*>(k),
             *pv = static_cast<const bf16*>(v);
  const unsigned char* pm = static_cast<const unsigned char*>(mask);
  bf16* po = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk > 64) {
    return static_cast<int>(digat::attention_fwd_wide<bf16>(
        pq, pk, pv, pm, po, N, H, L, dk, rs, hs, scale, wide_vec(ptrs, 4, rs, hs),
        g_max_smem_bf16, st));
  }
  const bool vec = copies16(ptrs, 4, rs);
  if (L > kResL) {
    return static_cast<int>(digat::attention_bf16_fwd_long(pq, pk, pv, pm, po, N, H, L, dk, rs,
                                                           hs, scale, vec, g_max_smem_bf16, st));
  }
  const BGeom b = bgeom(kBFwd, L, H, hs, vec);
  const long long units = static_cast<long long>(N) * b.groups;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = round_up(dk, 16) / 8;
  const BFwdKernel kern = hs % 2 ? bf16_fwd_kernel<false>(nt) : bf16_fwd_kernel<true>(nt);
  int blocks = 0, stages = 0;
  size_t smem = 0;
  resident_plan(kern, kBFwd, L, b, static_cast<int>(units), g_max_smem_bf16, g_sms, blocks,
                stages, smem);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<blocks, 32 * b.warps, smem, st>>>(pq, pk, pv, pm, po, static_cast<int>(units), stages,
                                           H, L, dk, rs, hs, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// dq, dk, dv [N, L, rs] (bf16) from q, k, v, the mask and do (bf16).
extern "C" int msa_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, void* dq, void* dk_out,
                                      void* dv_out, int N, int H, int L, int dk, int rs, int hs,
                                      float scale, void* stream) {
  if (bad_geometry_bf16(N, H, L, dk, rs, hs)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, dout, dq, dk_out, dv_out};
  const bf16 *pq = static_cast<const bf16*>(q), *pk = static_cast<const bf16*>(k),
             *pv = static_cast<const bf16*>(v), *pd = static_cast<const bf16*>(dout);
  const unsigned char* pm = static_cast<const unsigned char*>(mask);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk_out),
       *gv = static_cast<bf16*>(dv_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk > 64) {
    return static_cast<int>(digat::attention_bwd_wide<bf16>(
        pq, pk, pv, pm, pd, gq, gk, gv, N, H, L, dk, rs, hs, scale, wide_vec(ptrs, 7, rs, hs),
        g_max_smem_bf16, st));
  }
  const bool vec = copies16(ptrs, 7, rs);
  if (L > kResL) {
    return static_cast<int>(digat::attention_bf16_bwd_long(pq, pk, pv, pm, pd, gq, gk, gv, N, H,
                                                           L, dk, rs, hs, scale, vec,
                                                           g_max_smem_bf16, st));
  }
  return static_cast<int>(digat::attention_bf16_bwd_resident(
      pq, pk, pv, pm, pd, gq, gk, gv, N, H, L, dk, rs, hs, scale, vec, g_max_smem_bf16, g_sms, st));
}
