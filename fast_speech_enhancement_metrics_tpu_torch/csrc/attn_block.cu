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
// Design, one launch per routine, on Hopper's TMA and wgmma:
// * cast_kernel: an fp32 x rounded to a bf16 copy (bytes-bound: 157 MB read
//   and 78 MB written at the main path's shape); the products and the
//   residual read that copy, the TPU kernel's rounding at entry. A bf16 x
//   is read as it is;
// * gemm_sm90.cuh: QKV, W_o (A7), W_1, W_2 (A8), each with its epilogue
//   (bias, GELU, bf16 rounding) applied from registers;
// * flash_sm90.cuh's attention (sdpa.cu's instantiations, through
//   fsem_flash_attention), softmax exp2 / exp2_bf16 / exact: q, k and v
//   read in place from the (rows T, 3 d) qkv through strided 4-D TMA maps,
//   the context written into (rows T, d). Heads whose width is not a
//   multiple of 8 (TMA's 16-byte strides) are first copied into zero-padded
//   (rows, heads, T, hd8) q, k and v (pad_kernel) and their context copied
//   back (unpad_kernel): a layout step, the same kernel;
// * block_tiles.cuh's residual_ln_kernel, one warp per row.
// The qkv, the context, the (rows T, ffn) hidden and y pass through device
// memory between these launches (qkv is 235 MB at the main path's shape,
// ~0.07 ms of bytes). The two blocks' launch chains are exported as the
// stages of block_stages.cuh, which A11 (layer_block.cu) chains too.
#include <cuda_bf16.h>

#include "block_stages.cuh"
#include "block_tiles.cuh"
#include "flash_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

namespace gemm90 {

// C = epilogue(A B + bias) in bf16 (gemm_sm90.cuh): this translation unit
// instantiates the three bf16 epilogues, A12's the int8 one
inline cudaError_t gemm(const bf16* A, const bf16* B, const float* bias, void* C, int M, int N, int K, int epi,
                        cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, b_strides[1] = {(cuuint64_t)N * 2};
  if (!tensor_map(&ta, A, 2, a_dims, a_strides, kBM) || !tensor_map(&tb, B, 2, b_dims, b_strides, kBK))
    return cudaErrorInvalidValue;
  switch (epi) {
    case kBiasBf16: return launch<kBiasBf16>(ta, tb, nullptr, nullptr, bias, C, M, N, K, stream);
    case kBiasGeluBf16: return launch<kBiasGeluBf16>(ta, tb, nullptr, nullptr, bias, C, M, N, K, stream);
    case kBiasF32: return launch<kBiasF32>(ta, tb, nullptr, nullptr, bias, C, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gemm90

using bf16 = __nv_bfloat16;

constexpr int kCopyThreads = 256;

// blocks of the grid-stride copy kernels for n items, at most 4096
int copy_blocks(long long n) {
  const long long blocks = (n + kCopyThreads - 1) / kCopyThreads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

// out = bf16(x), 8 values a thread and step; n8 = elements / 8
__global__ void __launch_bounds__(kCopyThreads) cast_kernel(const float* __restrict__ x, bf16* __restrict__ out,
                                                            long long n8) {
  for (long long i = blockIdx.x * (long long)kCopyThreads + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kCopyThreads) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    reinterpret_cast<uint4*>(out)[i] = make_uint4(sm90::pack_bf16(a.x, a.y), sm90::pack_bf16(a.z, a.w),
                                                  sm90::pack_bf16(b.x, b.y), sm90::pack_bf16(b.z, b.w));
  }
}

// q, k, v of the (rows t_len, 3 d) qkv into padded[3][rows][heads][t_len][hd8],
// zeros past hd
__global__ void __launch_bounds__(kCopyThreads) pad_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ padded,
                                                           int rows, int t_len, int d, int heads, int hd8) {
  const int hd = d / heads;
  const long long n = 3LL * rows * heads * t_len * hd8;
  for (long long i = blockIdx.x * (long long)kCopyThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kCopyThreads) {
    const int c = (int)(i % hd8);
    long long rest = i / hd8;
    const int t = (int)(rest % t_len);
    rest /= t_len;
    const int h = (int)(rest % heads);
    rest /= heads;
    const int r = (int)(rest % rows);
    const int which = (int)(rest / rows);
    padded[i] = c < hd ? qkv[((long long)r * t_len + t) * 3 * d + which * d + h * hd + c] : __float2bfloat16(0.f);
  }
}

// the padded context o[rows][heads][t_len][hd8] back into ctx (rows t_len, d)
__global__ void __launch_bounds__(kCopyThreads) unpad_kernel(const bf16* __restrict__ o, bf16* __restrict__ ctx,
                                                             int rows, int t_len, int d, int heads, int hd8) {
  const int hd = d / heads;
  const long long n = (long long)rows * t_len * d;
  for (long long i = blockIdx.x * (long long)kCopyThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kCopyThreads) {
    const long long m = i / d;
    const int col = (int)(i % d);
    const int r = (int)(m / t_len), t = (int)(m % t_len);
    ctx[i] = o[(((long long)r * heads + col / hd) * t_len + t) * hd8 + col % hd];
  }
}

cudaError_t attention(const bf16* qkv, bf16* ctx, bf16* pad, int rows, int t_len, int d, int heads, int mode,
                      cudaStream_t stream) {
  const int hd = d / heads;
  if (hd % 8 == 0)
    return (cudaError_t)fsem_flash_attention(qkv, qkv + d, qkv + 2 * d, 3 * d, hd, (long long)t_len * 3 * d, ctx, d,
                                             hd, (long long)t_len * d, rows, heads, t_len, hd, mode, 1.f, 0.f,
                                             stream);
  const int hd8 = (hd + 7) / 8 * 8;
  const long long per = (long long)rows * heads * t_len * hd8;
  pad_kernel<<<copy_blocks(3 * per), kCopyThreads, 0, stream>>>(qkv, pad, rows, t_len, d, heads, hd8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bf16* o = pad + 3 * per;
  err = (cudaError_t)fsem_flash_attention(pad, pad + per, pad + 2 * per, hd8, (long long)t_len * hd8,
                                          (long long)heads * t_len * hd8, o, hd8, (long long)t_len * hd8,
                                          (long long)heads * t_len * hd8, rows, heads, t_len, hd8, mode, 1.f, 0.f,
                                          stream);
  if (err != cudaSuccess) return err;
  unpad_kernel<<<copy_blocks((long long)rows * t_len * d), kCopyThreads, 0, stream>>>(o, ctx, rows, t_len, d, heads,
                                                                                     hd8);
  return cudaGetLastError();
}

}  // namespace

namespace fsem {

cudaError_t cast_to_bf16(const float* x, bf16* out, long long n, cudaStream_t stream) {
  cast_kernel<<<copy_blocks(n / 8), kCopyThreads, 0, stream>>>(x, out, n / 8);
  return cudaGetLastError();
}

cudaError_t attn_stage(const bf16* x, const bf16* wqkv, const float* bqkv, const bf16* wo, const float* bo,
                       const float* lns, const float* lnb, bf16* qkv, bf16* ctx, float* y, bf16* pad, void* out,
                       int out_bf16, int rows, int t_len, int d, int heads, int mode, float eps, cudaStream_t stream) {
  const int M = rows * t_len;
  cudaError_t err = gemm90::gemm(x, wqkv, bqkv, qkv, M, 3 * d, d, gemm90::kBiasBf16, stream);
  if (err != cudaSuccess) return err;
  err = attention(qkv, ctx, pad, rows, t_len, d, heads, mode, stream);
  if (err != cudaSuccess) return err;
  err = gemm90::gemm(ctx, wo, bo, y, M, d, d, gemm90::kBiasF32, stream);
  if (err != cudaSuccess) return err;
  return out_bf16 ? tiles::residual_ln<bf16, bf16>(y, x, lns, lnb, static_cast<bf16*>(out), M, d, eps, stream)
                  : tiles::residual_ln<bf16, float>(y, x, lns, lnb, static_cast<float*>(out), M, d, eps, stream);
}

cudaError_t ffn_stage(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                      const float* lns, const float* lnb, bf16* hidden, float* y, void* out, int out_bf16, int M,
                      int d, int ffn, float eps, cudaStream_t stream) {
  cudaError_t err = gemm90::gemm(x, w1, b1, hidden, M, ffn, d, gemm90::kBiasGeluBf16, stream);
  if (err != cudaSuccess) return err;
  err = gemm90::gemm(hidden, w2, b2, y, M, d, ffn, gemm90::kBiasF32, stream);
  if (err != cudaSuccess) return err;
  return out_bf16 ? tiles::residual_ln<bf16, bf16>(y, x, lns, lnb, static_cast<bf16*>(out), M, d, eps, stream)
                  : tiles::residual_ln<bf16, float>(y, x, lns, lnb, static_cast<float*>(out), M, d, eps, stream);
}

}  // namespace fsem

// A7. x, out: (rows, t_len, d), both fp32 or both bf16 (x_bf16); wqkv:
// (d, 3 d) bf16, columns [q | k | v], q pre-scaled; bqkv: (3 d,) fp32;
// wo: (d, d) bf16; bo, lns, lnb: (d,) fp32; scratch xb (rows t_len, d)
// bf16 (unused when x is bf16), qkv (rows t_len, 3 d) bf16, ctx (rows
// t_len, d) bf16, y (rows t_len, d) fp32, pad (4 rows heads t_len hd8)
// bf16 where hd = d / heads is not a multiple of 8 (hd8 = hd rounded up
// to one; else unused). d % 32 == 0, d % heads == 0, hd <= 128; mode 0
// exp2, 1 exp2_bf16, 2 exact.
extern "C" int fsem_attn_block(const void* x, const void* wqkv, const float* bqkv, const void* wo, const float* bo,
                               const float* lns, const float* lnb, void* xb, void* qkv, void* ctx, float* y, void* pad,
                               void* out, int rows, int t_len, int d, int heads, int mode, int x_bf16, float eps,
                               void* stream_ptr) {
  if (rows <= 0 || t_len <= 0 || heads <= 0 || d % heads || d / heads > flash90::kMaxHead || d % 32 || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xin = static_cast<const bf16*>(x_bf16 ? x : xb);
  if (!x_bf16) {
    const cudaError_t err = fsem::cast_to_bf16(static_cast<const float*>(x), static_cast<bf16*>(xb),
                                               (long long)rows * t_len * d, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)fsem::attn_stage(xin, static_cast<const bf16*>(wqkv), bqkv, static_cast<const bf16*>(wo), bo, lns, lnb,
                               static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), y, static_cast<bf16*>(pad), out,
                               x_bf16, rows, t_len, d, heads, mode, eps, stream);
}

// A8. x, out: (M, d), both fp32 or both bf16 (x_bf16); w1: (d, ffn) bf16;
// b1: (ffn,) fp32; w2: (ffn, d) bf16; b2, lns, lnb: (d,) fp32; scratch xb
// (M, d) bf16 (unused when x is bf16), hidden (M, ffn) bf16, y (M, d) fp32.
// d % 32 == 0, ffn % 32 == 0. tanh GELU.
extern "C" int fsem_ffn_block(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                              const float* lns, const float* lnb, void* xb, void* hidden, float* y, void* out, int M,
                              int d, int ffn, int x_bf16, float eps, void* stream_ptr) {
  if (M <= 0 || d % 32 || ffn % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xin = static_cast<const bf16*>(x_bf16 ? x : xb);
  if (!x_bf16) {
    const cudaError_t err =
        fsem::cast_to_bf16(static_cast<const float*>(x), static_cast<bf16*>(xb), (long long)M * d, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)fsem::ffn_stage(xin, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, lns, lnb,
                              static_cast<bf16*>(hidden), y, out, x_bf16, M, d, ffn, eps, stream);
}

// The products of A7 and A8 alone: c (M, N) = epilogue(a (M, K) b (K, N) +
// bias), a, b bf16 row-major, bias (N,) fp32; epilogue 0 bf16, 1 tanh GELU
// then bf16, 2 fp32. K, N % 8 == 0.
extern "C" int fsem_gemm(const void* a, const void* b, const float* bias, void* c, int M, int N, int K, int epi,
                         void* stream_ptr) {
  return (int)gemm90::gemm(static_cast<const bf16*>(a), static_cast<const bf16*>(b), bias, c, M, N, K, epi,
                           static_cast<cudaStream_t>(stream_ptr));
}
