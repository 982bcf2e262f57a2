// Philox4x32-10 counter-based generator and the inverted-dropout rule,
// shared by the dropout kernels (dropout.cu), the MSA encoder's word-dropout
// pass (msa_title.cuh) and the products' dropout epilogue (tc_gemm.cuh): the
// one definition of which elements a dropout keeps and what it makes of them.
//
// The stream of a dropout site is keyed by (seed, site). Element (row, col)
// of a [rows, cols] tensor takes word col % 4 of the block at counter
// (col / 4, row, 0, 0). For the encoder's word dropout a row is one title
// (its absolute offset in the call) and col runs over its L * Din elements,
// so the mask of a title does not depend on how the titles are tiled.
// An element is kept iff its 32-bit draw is >= round(rate * 2^32).
// ops/dropout.py computes the same bits with int64 tensor arithmetic.
#pragma once

#include <stdint.h>

namespace digat {

struct Philox4 {
  uint32_t x, y, z, w;
};

__host__ __device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                          uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = uint64_t(0xD2511F53u) * c0;
    const uint64_t p1 = uint64_t(0xCD9E8D57u) * c2;
    const uint32_t hi0 = uint32_t(p0 >> 32), lo0 = uint32_t(p0);
    const uint32_t hi1 = uint32_t(p1 >> 32), lo1 = uint32_t(p1);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return Philox4{c0, c1, c2, c3};
}

// The ten round keys of a (seed, site) stream, (seed + r W0, site + r W1) in
// round r: computed once on the host and passed by value, a kernel's rounds
// read them as constants instead of adding them up in every thread.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__host__ __device__ inline PhiloxKeys philox_keys(uint32_t seed, uint32_t site) {
  PhiloxKeys k;
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = seed;
    k.k1[r] = site;
    seed += 0x9E3779B9u;
    site += 0xBB67AE85u;
  }
  return k;
}

// philox4x32_10 at counter (c0, c1, 0, 0) under round keys `k`: the same
// words as philox4x32_10(c0, c1, 0, 0, seed, site) for k = philox_keys(seed,
// site).
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, const PhiloxKeys& k) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = uint64_t(0xD2511F53u) * c0;
    const uint64_t p1 = uint64_t(0xCD9E8D57u) * c2;
    const uint32_t hi0 = uint32_t(p0 >> 32), lo0 = uint32_t(p0);
    const uint32_t hi1 = uint32_t(p1 >> 32), lo1 = uint32_t(p1);
    c0 = hi1 ^ c1 ^ k.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k.k1[r];
    c3 = lo0;
  }
  return Philox4{c0, c1, c2, c3};
}

// The four draws of elements 4*group .. 4*group+3 of `row`.
__host__ __device__ __forceinline__ Philox4 dropout_draws(uint32_t row, uint32_t group,
                                                          uint32_t seed, uint32_t site) {
  return philox4x32_10(group, row, 0u, 0u, seed, site);
}

// Inverted dropout of one element from its draw: kept (draw >= thresh) it is
// v * scale, scale the fp32 value of 1 / (1 - rate); dropped it is 0.
__device__ __forceinline__ float dropout_value(float v, uint32_t draw, uint32_t thresh,
                                               float scale) {
  return draw >= thresh ? v * scale : 0.f;
}

// The same for four consecutive elements and their block of draws.
__device__ __forceinline__ float4 dropout_value4(float4 v, const Philox4& d, uint32_t thresh,
                                                 float scale) {
  return make_float4(dropout_value(v.x, d.x, thresh, scale), dropout_value(v.y, d.y, thresh, scale),
                     dropout_value(v.z, d.z, thresh, scale), dropout_value(v.w, d.w, thresh, scale));
}

}  // namespace digat
