// The masked attention pair's bf16 instances (compute_dtype bfloat16) and
// their C entry points: q, k, v, do and every output bf16, the arithmetic
// fp32, each output rounded once to nearest even (msa_attention_kernels.cuh
// says what the kernels compute and how). A file of its own, so that nvcc
// compiles these 28 instantiations beside the fp32 ones, in parallel (the
// backward past 32 positions in msa_attention_bf16_long.cu).

#include "msa_attention_kernels.cuh"

extern "C" int msa_attention_bf16_init() {
  return static_cast<int>(init_impl<__nv_bfloat16>());
}

// out [N, L, rs] from q, k, v [N, L, rs] (bf16) and the optional key mask.
extern "C" int msa_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int N, int H, int L, int dk,
                                      int rs, int hs, float scale, void* stream) {
  return static_cast<int>(fwd_impl<__nv_bfloat16>(q, k, v, mask, out, N, H, L, dk, rs, hs, scale,
                                                  static_cast<cudaStream_t>(stream)));
}

// dq, dk, dv [N, L, rs] (bf16) from q, k, v, the mask and do (bf16).
extern "C" int msa_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, void* dq, void* dk_out,
                                      void* dv_out, int N, int H, int L, int dk, int rs, int hs,
                                      float scale, void* stream) {
  return static_cast<int>(bwd_impl<__nv_bfloat16>(q, k, v, mask, dout, dq, dk_out, dv_out, N, H,
                                                  L, dk, rs, hs, scale,
                                                  static_cast<cudaStream_t>(stream)));
}
