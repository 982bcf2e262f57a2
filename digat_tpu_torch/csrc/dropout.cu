// Inverted dropout (kernel A''), for sm_90a: the fused dropout of the
// training path and the materialised keep mask.
//
// Replaces the TPU helper digat_tpu/ops/pallas/msa_encoder.py
// (dropout_keep_mask, mask logic _keep_mask). The TPU drew its bits from the
// core's own generator seeded per (seed, title offset); these kernels draw
// them from Philox4x32-10 (philox.cuh) keyed by (seed, site) with counter
// (col / 4, row_offset + row), so the mask of a row is the same whatever
// rows a call covers. The MSA encoder kernels generate the same bits inline
// and never store them.
//
// dropout_apply_f32 is the graph encoders' dropout at every site, forward
// and backward: out[r, c] = keep(r, c) ? x[r, c] * scale : 0, scale the fp32
// value of 1 / (1 - rate), so that it equals torch's
// where(keep, x * (1 / (1 - rate)), 0) bit for bit. The backward is the
// same launch on the gradient under the same (seed, site): the same bits,
// so dx = keep * scale * g, and no mask is stored or saved.
// dropout_keep_mask_u8 writes the mask itself, for the tests and the check
// that the card draws the CPU's bits.
//
// dropout_apply_bf16 is the same fused pass on a bf16 tensor (compute_dtype
// bfloat16: the NRMS title tower's and MSA long titles' word dropout, the
// CNN encoder's two sites and the graph encoder's sites on bf16
// activations). There the JAX package runs XLA's jnp.where(mask, x / keep,
// 0).astype(bf16), which divides by keep rounded to bf16 (0.80078125 at
// rate 0.2) in fp32 and rounds the quotient to bf16 (ops/dropout.py's
// dropout_plain). This kernel multiplies by the fp32 value of 1 / keep
// instead, rounded to nearest (__fmul_rn; no -ftz in ops/build.py), then
// rounds to bf16: for every bf16 x and every bf16 keep above 2^-128 the two
// give the same bf16 bits (tests/test_torch_bf16_split.py checks it
// exhaustively; a rate in [0, 1) gives a keep of 2^-53 or more), so the
// outputs are dropout_plain's bit for bit. Its
// backward is the same pass on the bf16 gradient: the VJP of x / keep is
// g / keep, rounded to bf16.
//
// What bounds it on an H100. Per four elements one Philox block: 10 rounds
// of two 32x32->64 multiplies and two three-way xors, against 32 bytes moved
// by the fused fp32 pass (bytes bound it), 16 by the bf16 pass and 4 written
// by the mask. Both pipes count for the bf16 pass: at 16 bytes a block its
// integer issue (about 12-15 instructions an element) comes within a factor
// of two of the bytes' time, so chip_smoke.py bounds it by the larger of
// bytes / 3.35 TB/s and its SASS's integer instructions / the INT32 rate.
// At the training path's sizes ([320 x 68, 400] at most, 8.7 MB each way)
// an fp32 launch moves too little to fill the card for long: its time is
// the launch and, before this kernel, the host path around it: the mask
// kernel's wrapper, then a multiply, a zero scalar and a select in eager
// passes, and a select again backward.
// Design, fp32: one thread per four consecutive elements of a row, one
// Philox call each, float4 loads and stores when the row length is a
// multiple of 4; one launch a direction.
// Design, bf16 (dropout_bf16_kernel): where cols is a multiple of 4 the
// tensor is a flat run of groups of four (8 bytes, one Philox block each);
// a thread takes two groups as one 16-byte load and store when both arrays
// are 16-byte aligned, else one 8-byte group. A group's row is a 32-bit
// multiply-shift division by the row's groups (the wrapper computes the
// magic number, ops/dropout.py `divider`), the second group's row and
// column follow by one step; the ten round keys come in as kernel
// parameters (philox.cuh `PhiloxKeys`), so the rounds read them as
// constants. Other shapes and views take a thread per group of a row and
// 2-byte accesses. All index math is 32-bit: the wrapper refuses a tensor
// of 2^31 groups or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dropout_keep_mask_kernel(unsigned char* __restrict__ out, int64_t rows, int cols,
                         int64_t row_offset, uint32_t seed, uint32_t site, uint32_t thresh) {
  const int groups = (cols + 3) / 4;
  const int64_t total = rows * groups;
  for (int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x; t < total;
       t += int64_t(gridDim.x) * kThreads) {
    const int64_t r = t / groups;
    const int g = int(t - r * groups);
    const digat::Philox4 d =
        digat::dropout_draws(uint32_t(row_offset + r), uint32_t(g), seed, site);
    const unsigned char k0 = d.x >= thresh, k1 = d.y >= thresh, k2 = d.z >= thresh,
                        k3 = d.w >= thresh;
    unsigned char* o = out + r * cols + 4 * g;
    if (cols % 4 == 0) {
      *reinterpret_cast<uchar4*>(o) = make_uchar4(k0, k1, k2, k3);
    } else {
      const unsigned char k[4] = {k0, k1, k2, k3};
      for (int e = 0; e < 4 && 4 * g + e < cols; ++e) o[e] = k[e];
    }
  }
}

// one thread a group of four elements of a row; the arithmetic is
// philox.cuh's dropout_value (x * scale, as in the MSA encoder's
// word-dropout pass)
template <bool V4>
__global__ void __launch_bounds__(kThreads)
dropout_site_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t rows, int cols,
                     int64_t row_offset, uint32_t seed, uint32_t site, uint32_t thresh,
                     float scale) {
  const int groups = (cols + 3) / 4;
  const int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x;
  if (t >= rows * groups) return;
  const int64_t r = t / groups;
  const int g = int(t - r * groups);
  const digat::Philox4 d =
      digat::dropout_draws(uint32_t(row_offset + r), uint32_t(g), seed, site);
  const size_t at = size_t(r) * cols + 4 * g;
  if (V4) {
    digat::store4(out + at, digat::dropout_value4(digat::load4(x + at), d, thresh, scale));
  } else {
    const uint32_t k[4] = {d.x, d.y, d.z, d.w};
    for (int e = 0; e < 4 && 4 * g + e < cols; ++e)
      out[at + e] = digat::dropout_value(x[at + e], k[e], thresh, scale);
  }
}

// The bf16 pass's arithmetic on one element (its bf16 bits in the high half
// of a word): kept, bf16(x * inv_keep); dropped, 0.
__device__ __forceinline__ float drop_bf16(uint32_t bits_hi, uint32_t draw, uint32_t thresh,
                                           float inv_keep) {
  return draw >= thresh ? __fmul_rn(__uint_as_float(bits_hi), inv_keep) : 0.f;
}

// A group of four bf16 (two words) under its block of draws.
__device__ __forceinline__ uint2 drop_group_bf16(uint2 v, const digat::Philox4& d,
                                                 uint32_t thresh, float inv_keep) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(drop_bf16(v.x << 16, d.x, thresh, inv_keep),
                                                 drop_bf16(v.x & 0xffff0000u, d.y, thresh,
                                                           inv_keep));
  const __nv_bfloat162 b = __floats2bfloat162_rn(drop_bf16(v.y << 16, d.z, thresh, inv_keep),
                                                 drop_bf16(v.y & 0xffff0000u, d.w, thresh,
                                                           inv_keep));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// row = f / per_row for f < 2^31 by the wrapper's magic number
__device__ __forceinline__ uint32_t row_of(uint32_t f, uint32_t magic, uint32_t shift) {
  return uint32_t((uint64_t(f) * magic) >> shift);
}

// cols % 4 == 0: the tensor as `groups` groups of four (uint2), `per_row` a
// row; a thread takes kV consecutive groups (kV 2: one 16-byte access, both
// arrays 16-byte aligned), the last thread of an odd count one.
template <int kV>
__global__ void __launch_bounds__(kThreads)
dropout_bf16_kernel(const uint2* __restrict__ x, uint2* __restrict__ out, uint32_t groups,
                    uint32_t per_row, uint32_t magic, uint32_t shift, uint32_t row_offset,
                    uint32_t thresh, float inv_keep, const digat::PhiloxKeys keys) {
  const uint32_t f = (blockIdx.x * uint32_t(kThreads) + threadIdx.x) * kV;
  if (f >= groups) return;
  const uint32_t r = row_of(f, magic, shift), g = f - r * per_row;
  const digat::Philox4 d = digat::philox4x32_10(g, row_offset + r, keys);
  if (kV == 2 && f + 1 < groups) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + f));
    const bool wrap = g + 1 == per_row;  // the second group starts the next row
    const digat::Philox4 d1 =
        digat::philox4x32_10(wrap ? 0u : g + 1, row_offset + r + (wrap ? 1u : 0u), keys);
    const uint2 lo = drop_group_bf16(make_uint2(v.x, v.y), d, thresh, inv_keep);
    const uint2 hi = drop_group_bf16(make_uint2(v.z, v.w), d1, thresh, inv_keep);
    *reinterpret_cast<uint4*>(out + f) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else {
    out[f] = drop_group_bf16(__ldg(x + f), d, thresh, inv_keep);
  }
}

// any cols, any 2-byte alignment: a thread a group of four of a row (the
// last of a row short), element by element
__global__ void __launch_bounds__(kThreads)
dropout_bf16_rows_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ out,
                         uint32_t groups, uint32_t per_row, int cols, uint32_t magic,
                         uint32_t shift, uint32_t row_offset, uint32_t thresh, float inv_keep,
                         const digat::PhiloxKeys keys) {
  const uint32_t f = blockIdx.x * uint32_t(kThreads) + threadIdx.x;
  if (f >= groups) return;
  const uint32_t r = row_of(f, magic, shift), g = f - r * per_row;
  const digat::Philox4 d = digat::philox4x32_10(g, row_offset + r, keys);
  const uint32_t k[4] = {d.x, d.y, d.z, d.w};
  const size_t at = size_t(r) * cols + 4 * g;
  for (int e = 0; e < 4 && int(4 * g) + e < cols; ++e) {
    const __nv_bfloat16 y = __float2bfloat16_rn(
        drop_bf16(uint32_t(x[at + e]) << 16, k[e], thresh, inv_keep));
    out[at + e] = *reinterpret_cast<const unsigned short*>(&y);
  }
}

}  // namespace

// out: [rows, cols] bool (one byte each), written as 0 / 1.
extern "C" int dropout_keep_mask_u8(void* out, long long rows, int cols, long long row_offset,
                                    unsigned seed, unsigned site, unsigned thresh, void* stream) {
  if (rows < 0 || cols <= 0 || row_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long total = rows * ((cols + 3) / 4);
  const long long blocks_needed = (total + kThreads - 1) / kThreads;
  const int blocks = int(blocks_needed < 132 * 32 ? blocks_needed : 132 * 32);
  dropout_keep_mask_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out), rows, cols, row_offset, seed, site, thresh);
  return static_cast<int>(cudaGetLastError());
}

// out = keep ? x * scale : 0 over x [rows, cols] (row-major, contiguous,
// fp32): float4 loads and stores when cols is a multiple of 4 and both
// arrays are 16-byte aligned.
extern "C" int dropout_apply_f32(const void* x, void* out, long long rows, int cols,
                                 long long row_offset, unsigned seed, unsigned site,
                                 unsigned thresh, float scale, void* stream) {
  if (rows < 0 || cols <= 0 || row_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long blocks = (rows * ((cols + 3) / 4) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  if (cols % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0) {
    dropout_site_kernel<true><<<unsigned(blocks), kThreads, 0, st>>>(
        px, po, rows, cols, row_offset, seed, site, thresh, scale);
  } else {
    dropout_site_kernel<false><<<unsigned(blocks), kThreads, 0, st>>>(
        px, po, rows, cols, row_offset, seed, site, thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = keep ? bf16(x * inv_keep) : 0 over a bf16 x [rows, cols] (row-major,
// contiguous), inv_keep the fp32 value of 1 / bf16(1 - rate) (the same bits
// as bf16(x / bf16(1 - rate))). magic and shift divide a group index by
// ceil(cols / 4) (ops/dropout.py `divider`); rows * ceil(cols / 4) < 2^31
// and row_offset + rows <= 2^32.
extern "C" int dropout_apply_bf16(const void* x, void* out, long long rows, int cols,
                                  long long row_offset, unsigned seed, unsigned site,
                                  unsigned thresh, float inv_keep, unsigned magic, int shift,
                                  void* stream) {
  if (rows < 0 || cols <= 0 || row_offset < 0 || row_offset + rows > (1LL << 32) || shift < 31 ||
      shift > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long per_row = (cols + 3) / 4, groups = rows * per_row;
  if (groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const digat::PhiloxKeys keys = digat::philox_keys(seed, site);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const uint32_t g = uint32_t(groups), pr = uint32_t(per_row), off = uint32_t(row_offset);
  if (cols % 4 == 0 && align % 16 == 0) {
    dropout_bf16_kernel<2><<<unsigned((groups + 2 * kThreads - 1) / (2 * kThreads)), kThreads, 0,
                             st>>>(static_cast<const uint2*>(x), static_cast<uint2*>(out), g, pr,
                                   magic, unsigned(shift), off, thresh, inv_keep, keys);
  } else if (cols % 4 == 0 && align % 8 == 0) {
    dropout_bf16_kernel<1><<<unsigned((groups + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const uint2*>(x), static_cast<uint2*>(out), g, pr, magic, unsigned(shift),
        off, thresh, inv_keep, keys);
  } else {
    dropout_bf16_rows_kernel<<<unsigned((groups + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const unsigned short*>(x), static_cast<unsigned short*>(out), g, pr, cols,
        magic, unsigned(shift), off, thresh, inv_keep, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
