// Materialised inverted-dropout keep mask (kernel A''), for sm_90a.
//
// Replaces the TPU helper digat_tpu/ops/pallas/msa_encoder.py
// (dropout_keep_mask, mask logic _keep_mask). The TPU drew its bits from the
// core's own generator seeded per (seed, title offset); this kernel draws
// them from Philox4x32-10 (philox.cuh) keyed by (seed, site) with counter
// (col / 4, row_offset + row), so the mask of a row is the same whatever
// rows a call covers. The MSA encoder kernels generate the same bits inline
// and never store them; this entry point writes the mask for the graph
// encoder's dropout sites and for the tests.
//
// What bounds it on an H100: operations, narrowly. One Philox block (10
// rounds of two 32x32->64 multiplies, xors and key adds, about 104 integer
// operations) gives four mask bytes: about 26 operations per byte written,
// above the card's ridge of about 20 fp32 operations per byte. Design: one thread per four consecutive elements of a row, one
// Philox call each, a 4-byte store when the row is 4-aligned.

#include <cuda_runtime.h>
#include <stdint.h>

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
