// Residual + LayerNorm of the post-LN encoder blocks, the last stage of
// A7, A8 (attn_block.cu, and so A11) and A12 (attn_block_int8.cu); their
// products are gemm_sm90.cuh's.
//
// residual_ln_row: one warp per row of d: r = y + bf16(x), mean and
// centered variance in fp32, r' = (r - mean) rsqrt(var + eps) s + b;
// residual_ln_kernel runs it over all rows in one launch.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace {
namespace tiles {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float bf16_round(bf16 v) { return __bfloat162float(v); }

// out[m] = LN(y[m] + bf16(x[m])) over n columns by one warp, lane l taking
// columns l, l + 32, ...; out in TO (x's type, unless x is already its bf16
// copy). Rows of up to 32 kPer columns are read once into registers, all
// loads in flight together; wider ones are read three times. The sums run
// in the same order either way.
constexpr int kPer = 40;  // d up to 1280 (HuBERT-xlarge) in registers
template <typename TX, typename TO = TX>
__device__ __forceinline__ void residual_ln_row(const float* __restrict__ y, const TX* __restrict__ x,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ shift, TO* __restrict__ out,
                                                int m, int n, float eps, int lane) {
  const float* yr = y + (size_t)m * n;
  const TX* xr = x + (size_t)m * n;
  TO* o = out + (size_t)m * n;
  float sum = 0.f, sq = 0.f;
  if (n <= 32 * kPer) {
    float r[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      r[i] = c < n ? yr[c] + bf16_round(xr[c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum += r[i];  // the zeros past n add nothing
    const float mean = fsem::warp_sum(sum) / (float)n;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (lane + 32 * i < n) sq = fmaf(r[i] - mean, r[i] - mean, sq);
    }
    const float inv = rsqrtf(fsem::warp_sum(sq) / (float)n + eps);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < n) store_out(o + c, (r[i] - mean) * inv * scale[c] + shift[c]);
    }
    return;
  }
  for (int c = lane; c < n; c += 32) sum += yr[c] + bf16_round(xr[c]);
  const float mean = fsem::warp_sum(sum) / (float)n;
  for (int c = lane; c < n; c += 32) {
    const float v = yr[c] + bf16_round(xr[c]) - mean;
    sq = fmaf(v, v, sq);
  }
  const float inv = rsqrtf(fsem::warp_sum(sq) / (float)n + eps);
  for (int c = lane; c < n; c += 32) {
    const float v = yr[c] + bf16_round(xr[c]) - mean;
    store_out(o + c, v * inv * scale[c] + shift[c]);
  }
}

constexpr int kLnWarps = 8;

// residual_ln_row over M rows as one launch, one warp per row (A7, A8, A12)
template <typename TX, typename TO>
__global__ void __launch_bounds__(kLnWarps * 32) residual_ln_kernel(
    const float* __restrict__ y, const TX* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, TO* __restrict__ out, int M, int n, float eps) {
  const int m = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  residual_ln_row<TX, TO>(y, x, scale, shift, out, m, n, eps, threadIdx.x & 31);
}

template <typename TX, typename TO = TX>
cudaError_t residual_ln(const float* y, const TX* x, const float* s, const float* b, TO* out,
                        int M, int n, float eps, cudaStream_t stream) {
  residual_ln_kernel<TX, TO><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      y, x, s, b, out, M, n, eps);
  return cudaGetLastError();
}

}  // namespace tiles
}  // namespace
