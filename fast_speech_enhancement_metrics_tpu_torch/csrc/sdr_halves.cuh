// The bf16 halves of SDR's signal pairs, split once, up front, for the two
// tensor-core correlation kernels: A4 (sdr_corr_gram.cu) and A10
// (sdr_corr_fused.cu).
//
// out (4, batch, row_len) bf16, the planes [clean hi, clean lo, denoised
// hi, denoised lo] with hi = bf16(x) and lo = bf16(x - hi), rounded to
// nearest even (ops/sdr_corr_gram.py::_hi_lo, as the JAX kernels split);
// samples at and past t_len are zeros, so each row is the zero-padded
// signal that the kernels' TMA maps read in frames or chunks. x - hi is
// exact in float32. With lo == 0 the lo planes are not written (split x1
// reads the hi planes only). row_len % 8 == 0.
//
// Bound by bytes: 8 read and 8 (hi only: 4) written per sample and pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace halves {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // samples a thread: one 16-byte load per signal, one 8-byte store per plane

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// grid (row_len / (kThreads kPer), batch): neighbouring threads on
// neighbouring samples, so that each warp's loads and stores are whole
// 512- and 256-byte runs
__global__ void __launch_bounds__(kThreads) split_kernel(const float* __restrict__ c, const float* __restrict__ d,
                                                         __nv_bfloat16* __restrict__ out, long long t_len,
                                                         long long row_len, int batch, int lo, int vec) {
  const long long t0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (t0 >= row_len) return;
  const int b = blockIdx.y;
  const size_t plane = (size_t)batch * row_len;
  float x[2][kPer];
#pragma unroll
  for (int sig = 0; sig < 2; ++sig) {  // both loads in flight before any store
    const float* src = (sig ? d : c) + (size_t)b * t_len;
    if (vec && t0 + kPer <= t_len) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src + t0));
      x[sig][0] = v.x, x[sig][1] = v.y, x[sig][2] = v.z, x[sig][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) x[sig][e] = t0 + e < t_len ? src[t0 + e] : 0.f;
    }
  }
#pragma unroll
  for (int sig = 0; sig < 2; ++sig) {
    uint32_t hw[kPer / 2], lw[kPer / 2];
#pragma unroll
    for (int e = 0; e < kPer / 2; ++e) {
      const float a = x[sig][2 * e], bb = x[sig][2 * e + 1];
      const __nv_bfloat16 h0 = __float2bfloat16_rn(a), h1 = __float2bfloat16_rn(bb);
      hw[e] = pack2(h0, h1);
      lw[e] = pack2(__float2bfloat16_rn(a - __bfloat162float(h0)), __float2bfloat16_rn(bb - __bfloat162float(h1)));
    }
    __nv_bfloat16* dst = out + (size_t)(2 * sig) * plane + (size_t)b * row_len + t0;
    *reinterpret_cast<uint2*>(dst) = make_uint2(hw[0], hw[1]);
    if (lo) *reinterpret_cast<uint2*>(dst + plane) = make_uint2(lw[0], lw[1]);
  }
}

// clean, denoised (batch, t_len) float32; out (4, batch, row_len) bf16,
// 16-byte aligned; row_len >= t_len, row_len % 8 == 0
inline cudaError_t split(const float* c, const float* d, void* out, long long t_len, long long row_len, int batch,
                         bool lo, cudaStream_t stream) {
  if (row_len % 8 || row_len < t_len || batch <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int vec = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const long long per_block = (long long)kThreads * kPer;
  const dim3 grid((unsigned)((row_len + per_block - 1) / per_block), batch);
  split_kernel<<<grid, kThreads, 0, stream>>>(c, d, static_cast<__nv_bfloat16*>(out), t_len, row_len, batch, lo,
                                              vec);
  return cudaGetLastError();
}

}  // namespace halves
}  // namespace
