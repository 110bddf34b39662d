// HuBERT post-LN encoder blocks in bf16 with fp32 accumulation.
//
// Replaces two Pallas TPU kernels of the JAX package's
// ops/attn_block_pallas.py:
//   A7 _attn_block_kernel (attn_block): y = LN(x + W_o attn(x W_qkv + b) + b_o)
//   A8 _ffn_block_kernel (ffn_block):   y = LN(x + W_2 gelu_tanh(x W_1 + b_1) + b_2)
// per row of a (rows, T, d) activation, with the TPU kernel's roundings:
// x rounded to bf16 at entry (the residual adds that rounded x); bf16
// operands and fp32 accumulation in every product; qkv, the probabilities,
// the normalised context and the FFN hidden rounded to bf16; LayerNorm
// statistics in fp32. The attention scale (and log2 e for the exp2 modes)
// is folded into the q columns of W_qkv before they were rounded to bf16
// (ops/attn_block_pallas.py::pack_attn_block_params).
//
// What bounds it on this card: operations. At mHuBERT-147's width (d 768,
// 12 heads of 64, FFN 3072) and 64 rows of 799 frames, A7 is about 0.37
// TFLOP and A8 0.48 TFLOP of bf16 tensor-core work per launch (0.37 and
// 0.49 ms at 989 TFLOP/s), against about 0.2 GB of bytes each (0.06 ms).
//
// Design (a first, simple version: nvcuda::wmma 16x16x16 bf16 fragments,
// which compile to mma.sync; no wgmma or TMA yet), one launch per routine:
// * gemm_kernel: block_tiles.cuh's gemm_tile, one 128 x 128 output tile per
//   block; T need not be a multiple of 16, and nothing is padded in device
//   memory;
// * attention: attention_core.cuh (shared with A9 / A15), bf16 arm, one
//   block of 4 warps per (row, head, tile of 64 queries), key tiles of 64
//   through shared memory, any head width up to 128 (zero-padded to a
//   multiple of 16), softmax exp2 / exp2_bf16 / exact; ctx / l rounded to
//   bf16;
// * block_tiles.cuh's residual_ln_kernel, one warp per row.
// The (rows x T, 3d) qkv, the context and the (rows x T, ffn) hidden pass
// through device memory between these launches. A11 (layer_block.cu) runs
// the same routines in one persistent launch.
#include <cuda_bf16.h>

#include "attention_core.cuh"
#include "block_tiles.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tiles;

template <typename TA, int kEpi, typename TC>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    const TA* __restrict__ A, const bf16* __restrict__ B, const float* __restrict__ bias,
    TC* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) GemmSmem sm;
  gemm_tile<TA, kEpi, TC>(A, B, bias, C, M, N, K, blockIdx.y, blockIdx.x, sm, threadIdx.x);
}

template <typename TA, int kEpi, typename TC>
cudaError_t gemm(const TA* A, const bf16* B, const float* bias, TC* C, int M, int N, int K,
                 cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TA, kEpi, TC><<<grid, kGemmThreads, 0, stream>>>(A, B, bias, C, M, N, K);
  return cudaGetLastError();
}

// -- blocks -------------------------------------------------------------------------

template <typename TX>
int attn_block(const void* xv, const bf16* wqkv, const float* bqkv, const bf16* wo,
               const float* bo, const float* lns, const float* lnb, bf16* qkv, bf16* ctx,
               float* y, void* outv, int rows, int t_len, int d, int heads, int mode,
               float eps, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xv);
  const int M = rows * t_len;
  cudaError_t err = gemm<TX, kBiasBf16, bf16>(x, wqkv, bqkv, qkv, M, 3 * d, d, stream);
  if (err != cudaSuccess) return (int)err;
  const attn::Args a = attn::qkv_args(qkv, ctx, t_len, d, heads);
  if (mode == attn::kExp2) {
    err = attn::launch_any_width<bf16, attn::kExp2>(a, heads, rows, stream);
  } else if (mode == attn::kExp2Bf16) {
    err = attn::launch_any_width<bf16, attn::kExp2Bf16>(a, heads, rows, stream);
  } else if (mode == attn::kExact) {
    err = attn::launch_any_width<bf16, attn::kExact>(a, heads, rows, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = gemm<bf16, kBiasF32, float>(ctx, wo, bo, y, M, d, d, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)residual_ln<TX>(y, x, lns, lnb, static_cast<TX*>(outv), M, d, eps, stream);
}

template <typename TX>
int ffn_block(const void* xv, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
              const float* lns, const float* lnb, bf16* hidden, float* y, void* outv, int M,
              int d, int ffn, float eps, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xv);
  cudaError_t err = gemm<TX, kBiasGeluBf16, bf16>(x, w1, b1, hidden, M, ffn, d, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm<bf16, kBiasF32, float>(hidden, w2, b2, y, M, d, ffn, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)residual_ln<TX>(y, x, lns, lnb, static_cast<TX*>(outv), M, d, eps, stream);
}

}  // namespace

// A7. x, out: (rows, t_len, d), both fp32 or both bf16 (x_bf16); wqkv:
// (d, 3 d) bf16, columns [q | k | v], q pre-scaled; bqkv: (3 d,) fp32;
// wo: (d, d) bf16; bo, lns, lnb: (d,) fp32; scratch qkv (rows t_len, 3 d)
// bf16, ctx (rows t_len, d) bf16, y (rows t_len, d) fp32. d % 32 == 0,
// d % heads == 0, d / heads <= 128; mode 0 exp2, 1 exp2_bf16, 2 exact.
extern "C" int fsem_attn_block(const void* x, const void* wqkv, const float* bqkv,
                               const void* wo, const float* bo, const float* lns,
                               const float* lnb, void* qkv, void* ctx, float* y, void* out,
                               int rows, int t_len, int d, int heads, int mode, int x_bf16,
                               float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (heads <= 0 || d % heads || d / heads > attn::kMaxHead || d % kBK) return (int)cudaErrorInvalidValue;
  auto block = x_bf16 ? attn_block<bf16> : attn_block<float>;
  return block(x, static_cast<const bf16*>(wqkv), bqkv, static_cast<const bf16*>(wo), bo, lns,
               lnb, static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), y, out, rows, t_len, d,
               heads, mode, eps, stream);
}

// A8. x, out: (M, d), both fp32 or both bf16 (x_bf16); w1: (d, ffn) bf16;
// b1: (ffn,) fp32; w2: (ffn, d) bf16; b2, lns, lnb: (d,) fp32; scratch
// hidden (M, ffn) bf16, y (M, d) fp32. d % 32 == 0, ffn % 32 == 0. tanh GELU.
extern "C" int fsem_ffn_block(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, const float* lns, const float* lnb,
                              void* hidden, float* y, void* out, int M, int d, int ffn,
                              int x_bf16, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d % kBK || ffn % kBK) return (int)cudaErrorInvalidValue;
  auto block = x_bf16 ? ffn_block<bf16> : ffn_block<float>;
  return block(x, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, lns, lnb,
               static_cast<bf16*>(hidden), y, out, M, d, ffn, eps, stream);
}
