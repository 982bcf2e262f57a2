// The masked attention pair's fp32 backward past 32 positions
// (msa_attention_bwd_long_kernel; msa_attention_kernels.cuh says what it
// computes and how). A file of its own, so that nvcc compiles its 14
// instantiations beside the rest of the pair, in parallel;
// msa_attention.cu's entry points reach it through
// digat::attention_bwd_long<float>.

#define DIGAT_ATTENTION_LONG
#include "msa_attention_kernels.cuh"

template cudaError_t digat::attention_long_init<float>(int max_smem);
template cudaError_t digat::attention_bwd_long<float>(
    const float* q, const float* k, const float* v, const unsigned char* mask, const float* dout,
    float* dq, float* dk_out, float* dv_out, int N, int H, int L, int dk, int rs, int hs,
    float scale, bool vec, int max_smem, cudaStream_t stream);
