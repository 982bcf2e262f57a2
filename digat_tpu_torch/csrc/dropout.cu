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
// rate 0.2) in fp32 and rounds the quotient to bf16; so does this kernel
// (philox.cuh's dropout_divide), with the same Philox mask, bit for bit
// with ops/dropout.py's dropout_plain. Its backward is the same pass on the
// bf16 gradient: the VJP of x / keep is g / keep, rounded to bf16.
//
// What bounds it on an H100. Per four elements one Philox block: 10 rounds
// of two 32x32->64 multiplies, xors and key adds, about 104 integer
// operations, against 32 bytes moved by the fused pass (about 3 operations a
// byte, under the card's ridge: bytes bound it) and 4 bytes written by the
// mask (about 26 a byte: operations). At the training path's sizes
// ([320 x 68, 400] at most, 8.7 MB each way) a launch moves too little to
// fill the card for long: its time is the launch and, before this kernel,
// the host path around it: the mask kernel's wrapper, then a multiply, a
// zero scalar and a select in eager passes, and a select again backward.
// Design: one thread per four consecutive elements of a row, one Philox call
// each, float4 loads and stores when the row length is a multiple of 4; one
// launch a direction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one thread a group of four elements of a row; the arithmetic is
// philox.cuh's dropout_value (fp32: x * scale, as in the MSA encoder's
// word-dropout pass) or dropout_divide (bf16: x / keep, rounded to bf16),
// `factor` being scale or keep
template <bool V4, typename T>
__global__ void __launch_bounds__(kThreads)
dropout_site_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows, int cols,
                     int64_t row_offset, uint32_t seed, uint32_t site, uint32_t thresh,
                     float factor) {
  constexpr bool kDivide = std::is_same<T, __nv_bfloat16>::value;
  const int groups = (cols + 3) / 4;
  const int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x;
  if (t >= rows * groups) return;
  const int64_t r = t / groups;
  const int g = int(t - r * groups);
  const digat::Philox4 d =
      digat::dropout_draws(uint32_t(row_offset + r), uint32_t(g), seed, site);
  const size_t at = size_t(r) * cols + 4 * g;
  if (V4) {
    const float4 v = digat::load4(x + at);
    digat::store4(out + at, kDivide ? digat::dropout_divide4(v, d, thresh, factor)
                                    : digat::dropout_value4(v, d, thresh, factor));
  } else {
    const uint32_t k[4] = {d.x, d.y, d.z, d.w};
    for (int e = 0; e < 4 && 4 * g + e < cols; ++e) {
      const float v = to_float(x[at + e]);
      store(out + at + e, kDivide ? digat::dropout_divide(v, k[e], thresh, factor)
                                  : digat::dropout_value(v, k[e], thresh, factor));
    }
  }
}

// one launch of dropout_site_kernel over [rows, cols]: groups of four when
// cols is a multiple of 4 and both arrays are aligned to four elements
template <typename T>
int apply(const void* x, void* out, long long rows, int cols, long long row_offset,
          unsigned seed, unsigned site, unsigned thresh, float factor, void* stream) {
  if (rows < 0 || cols <= 0 || row_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long blocks = (rows * ((cols + 3) / 4) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* px = static_cast<const T*>(x);
  T* po = static_cast<T*>(out);
  if (cols % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % (4 * sizeof(T)) == 0) {
    dropout_site_kernel<true, T><<<unsigned(blocks), kThreads, 0, st>>>(
        px, po, rows, cols, row_offset, seed, site, thresh, factor);
  } else {
    dropout_site_kernel<false, T><<<unsigned(blocks), kThreads, 0, st>>>(
        px, po, rows, cols, row_offset, seed, site, thresh, factor);
  }
  return static_cast<int>(cudaGetLastError());
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
  return apply<float>(x, out, rows, cols, row_offset, seed, site, thresh, scale, stream);
}

// out = keep ? bf16(x / keep_value) : 0 over a bf16 x [rows, cols]
// (row-major, contiguous), keep_value the fp32 value of bf16(1 - rate):
// groups of four when cols is a multiple of 4 and both arrays are 8-byte
// aligned.
extern "C" int dropout_apply_bf16(const void* x, void* out, long long rows, int cols,
                                  long long row_offset, unsigned seed, unsigned site,
                                  unsigned thresh, float keep_value, void* stream) {
  return apply<__nv_bfloat16>(x, out, rows, cols, row_offset, seed, site, thresh, keep_value,
                              stream);
}
