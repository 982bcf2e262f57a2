// The masked attention pair's fp32 instances and their C entry points. The
// kernels, what they replace, what bounds them and how they are laid out:
// msa_attention_kernels.cuh. The backward past 32 positions is
// msa_attention_long.cu, the bf16 instances msa_attention_bf16.cu and
// msa_attention_bf16_long.cu, the wide instance (dk 65-128)
// msa_attention_wide.cu.

#include "msa_attention_kernels.cuh"

extern "C" int msa_attention_init() { return static_cast<int>(init_impl<float>()); }

// out [N, L, rs] from q, k, v [N, L, rs] (fp32) and the optional key mask
// [N, L] (bytes, nonzero = keep; null = keep all).
extern "C" int msa_attention_fwd_f32(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int N, int H, int L, int dk,
                                     int rs, int hs, float scale, void* stream) {
  return static_cast<int>(fwd_impl<float>(q, k, v, mask, out, N, H, L, dk, rs, hs, scale,
                                          static_cast<cudaStream_t>(stream)));
}

// dq, dk, dv [N, L, rs] from q, k, v, the mask and the output gradient do.
extern "C" int msa_attention_bwd_f32(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, void* dq, void* dk_out,
                                     void* dv_out, int N, int H, int L, int dk, int rs, int hs,
                                     float scale, void* stream) {
  return static_cast<int>(bwd_impl<float>(q, k, v, mask, dout, dq, dk_out, dv_out, N, H, L, dk,
                                          rs, hs, scale, static_cast<cudaStream_t>(stream)));
}
