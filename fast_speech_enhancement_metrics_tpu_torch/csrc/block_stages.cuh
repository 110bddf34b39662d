// The stages of the post-LN encoder blocks, as host functions that launch
// on a stream and return cudaGetLastError(). Defined in attn_block.cu, the
// one translation unit that instantiates their kernels; A7 and A8
// (attn_block.cu) and A11 (layer_block.cu) chain them.
//
// x is the block's input already in bf16 (A7 / A8 cast an fp32 x first);
// out is bf16 (out_bf16) or fp32. Scratch as fsem_attn_block /
// fsem_ffn_block name it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fsem {

// out = bf16(x) over n values (n % 8 == 0)
cudaError_t cast_to_bf16(const float* x, __nv_bfloat16* out, long long n, cudaStream_t stream);

// out = LN(x + W_o attn(x W_qkv + b_qkv) + b_o) over (rows t_len, d)
cudaError_t attn_stage(const __nv_bfloat16* x, const __nv_bfloat16* wqkv, const float* bqkv,
                       const __nv_bfloat16* wo, const float* bo, const float* lns, const float* lnb,
                       __nv_bfloat16* qkv, __nv_bfloat16* ctx, float* y, __nv_bfloat16* pad, void* out, int out_bf16,
                       int rows, int t_len, int d, int heads, int mode, float eps, cudaStream_t stream);

// out = LN(x + W_2 gelu_tanh(x W_1 + b_1) + b_2) over (M, d)
cudaError_t ffn_stage(const __nv_bfloat16* x, const __nv_bfloat16* w1, const float* b1, const __nv_bfloat16* w2,
                      const float* b2, const float* lns, const float* lnb, __nv_bfloat16* hidden, float* y, void* out,
                      int out_bf16, int M, int d, int ffn, float eps, cudaStream_t stream);

}  // namespace fsem
