// One whole post-LN HuBERT encoder layer.
//
// Replaces the Pallas TPU kernel ops/attn_block_pallas.py::_layer_block_kernel
// of the JAX package (A11, layer_block): A7's attention block, then A8's FFN
// block, with x crossing from one to the other:
//   h = LN1(x + W_o attn(x W_qkv + b_qkv) + b_o),
//   y = LN2(h + W_2 gelu_tanh(h W_1 + b_1) + b_2),
// with A7's and A8's roundings (attn_block.cu).
//
// What bounds it on this card: operations, A7's plus A8's: about 0.85 TFLOP
// of bf16 tensor-core work per launch at mHuBERT-147's width and 64 rows of
// 799 frames (0.86 ms at 989 TFLOP/s).
//
// Design: A7's and A8's Hopper launches in a chain (block_stages.cuh):
//   1. an fp32 x cast to bf16 (a bf16 x is read as it is);
//   2. attn_stage: the QKV GEMM, the flash attention reading q, k, v in
//      place (zero-padded copies for heads not a multiple of 8), the W_o
//      GEMM, residual + LN1 written straight to a bf16 h;
//   3. ffn_stage on h: the W_1 GEMM with the GELU, the W_2 GEMM, residual
//      + LN2 into out in x's dtype.
// The one fusion is the TPU kernel's point, one fewer round trip of the
// intermediate: A7 then A8 writes h in x's dtype and A8 rounds it to bf16
// at entry, which both its products and its residual read; here LN1 writes
// bf16(h) once, the same values, and no fp32 h or cast launch. So the
// result is A7 then A8's bit for bit, in every softmax mode and x dtype,
// at every head width A7 takes.
#include <cuda_bf16.h>

#include "block_stages.cuh"

using bf16 = __nv_bfloat16;

// A11. x, out: (rows, t_len, d), both fp32 or both bf16 (x_bf16); wqkv,
// bqkv, wo, bo, ln1 scale / shift as A7's (attn_block.cu); w1, b1, w2, b2,
// ln2 scale / shift as A8's; scratch xb (rows t_len, d) bf16 (unused when x
// is bf16), qkv (rows t_len, 3 d) bf16, ctx (rows t_len, d) bf16, y (rows
// t_len, d) fp32, h (rows t_len, d) bf16, hidden (rows t_len, ffn) bf16,
// pad as A7's. d % 32 == 0, ffn % 32 == 0, d % heads == 0, d / heads <=
// 128; mode 0 exp2, 1 exp2_bf16, 2 exact; tanh GELU.
extern "C" int fsem_layer_block(const void* x, const void* wqkv, const float* bqkv, const void* wo, const float* bo,
                                const float* ln1s, const float* ln1b, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* ln2s, const float* ln2b, void* xb, void* qkv, void* ctx,
                                float* y, void* h, void* hidden, void* pad, void* out, int rows, int t_len, int d,
                                int heads, int ffn, int mode, int x_bf16, float eps, void* stream_ptr) {
  if (rows <= 0 || t_len <= 0 || heads <= 0 || d % heads || d / heads > 128 || d % 32 || ffn % 32 || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = rows * t_len;
  const bf16* xin = static_cast<const bf16*>(x_bf16 ? x : xb);
  cudaError_t err = cudaSuccess;
  if (!x_bf16) {
    err = fsem::cast_to_bf16(static_cast<const float*>(x), static_cast<bf16*>(xb), (long long)M * d, stream);
    if (err != cudaSuccess) return (int)err;
  }
  bf16* hb = static_cast<bf16*>(h);
  err = fsem::attn_stage(xin, static_cast<const bf16*>(wqkv), bqkv, static_cast<const bf16*>(wo), bo, ln1s, ln1b,
                         static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), y, static_cast<bf16*>(pad), hb, 1, rows,
                         t_len, d, heads, mode, eps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)fsem::ffn_stage(hb, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, ln2s, ln2b,
                              static_cast<bf16*>(hidden), y, out, x_bf16, M, d, ffn, eps, stream);
}
