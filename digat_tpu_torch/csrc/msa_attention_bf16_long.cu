// The masked attention pair's bf16 backward past 32 positions, as
// msa_attention_long.cu is its fp32 one; msa_attention_bf16.cu's entry
// points reach it through digat::attention_bwd_long<__nv_bfloat16>.

#define DIGAT_ATTENTION_LONG
#include "msa_attention_kernels.cuh"

using bf16 = __nv_bfloat16;

template cudaError_t digat::attention_long_init<bf16>(int max_smem);
template cudaError_t digat::attention_bwd_long<bf16>(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask, const bf16* dout,
    bf16* dq, bf16* dk_out, bf16* dv_out, int N, int H, int L, int dk, int rs, int hs,
    float scale, bool vec, int max_smem, cudaStream_t stream);
