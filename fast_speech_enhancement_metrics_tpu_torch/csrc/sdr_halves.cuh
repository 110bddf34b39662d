// The bf16 pieces of signal pairs, split once, up front, for the tensor-core
// kernels that read them through TMA: the hi / lo halves of SDR's two
// correlation kernels, A4 (sdr_corr_gram.cu) and A10 (sdr_corr_fused.cu),
// and the three pieces of LSD's frame-tile kernel (lsd_fused.cu).
//
// split<kPieces>: out (2 kPieces, batch, row_len) bf16, the planes [clean
// x0 .. x(kPieces - 1), denoised x0 .. x(kPieces - 1)] with x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), rounded to nearest even; each
// difference is exact in float32. Two pieces are SDR's hi / lo
// (ops/sdr_corr_gram.py::_hi_lo, as the JAX kernels split), three LSD's
// (ops/lsd_fused.py::_split_pieces_plain). Samples at and past t_len are
// zeros, so each row is the zero-padded signal that the kernels' TMA maps
// read in frames or chunks. With rest == false only the x0 planes are
// written (split x1 reads the hi planes only). row_len % 8 == 0.
// kScaleSplits > 0: d is first scaled by its row's projection scale (A1 of
// lsd_fused.cu), formed from per-row (num, den) partials added in order.
//
// Bound by bytes: 8 read and 4 kPieces (x0 only: 4) written per sample
// and pair.
//
// split_rows<kPieces>: the same pieces of three float32 (rows, hd)
// matrices, each into (kPieces, rows, ld) bf16 planes with the columns hd
// .. ld zeros: the operands of the float32 attention arm
// (flash_f32_sm90.cuh), q, k and v of (B H T) rows. Bound by bytes: 4 read
// and 2 kPieces ld / hd written per element.
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

// the kPieces pieces of two neighbouring values, each piece's pair packed
// (a in the low half)
template <int kPieces>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&w)[kPieces]) {
  __nv_bfloat16 p[kPieces][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r = h ? b : a;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      p[q][h] = __float2bfloat16_rn(r);
      r = __fsub_rn(r, __bfloat162float(p[q][h]));
    }
  }
#pragma unroll
  for (int q = 0; q < kPieces; ++q) w[q] = pack2(p[q][0], p[q][1]);
}

// grid (row_len / (kThreads kPer), batch): neighbouring threads on
// neighbouring samples, so that each warp's loads and stores are whole
// 512- and 256-byte runs. written: the pieces stored per signal (1 or
// kPieces). kScaleSplits > 0: d is multiplied by its row's scale sum(num) /
// (sum(den) + eps), from scale_partial (batch, kScaleSplits, 2) added in
// order; the product is rounded to float32 before the split, as the plain
// version's d * scale.
template <int kPieces, int kScaleSplits>
__global__ void __launch_bounds__(kThreads) split_kernel(const float* __restrict__ c, const float* __restrict__ d,
                                                         const float* __restrict__ scale_partial,
                                                         __nv_bfloat16* __restrict__ out, long long t_len,
                                                         long long row_len, int batch, int written, int vec,
                                                         float eps) {
  __shared__ float s_scale;
  const int b = blockIdx.y;
  if (kScaleSplits > 0) {
    if (threadIdx.x == 0) {
      float num = 0.f, den = 0.f;
      for (int i = 0; i < kScaleSplits; ++i) {
        num += scale_partial[((size_t)b * kScaleSplits + i) * 2];
        den += scale_partial[((size_t)b * kScaleSplits + i) * 2 + 1];
      }
      s_scale = num / (den + eps);
    }
    __syncthreads();
  }
  const long long t0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (t0 >= row_len) return;
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
  if (kScaleSplits > 0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[1][e] = __fmul_rn(x[1][e], s_scale);  // never contracted into a later FMA
  }
#pragma unroll
  for (int sig = 0; sig < 2; ++sig) {
    uint32_t w[2][kPieces];
#pragma unroll
    for (int e = 0; e < kPer / 2; ++e) split_pair<kPieces>(x[sig][2 * e], x[sig][2 * e + 1], w[e]);
    __nv_bfloat16* dst = out + (size_t)(kPieces * sig) * plane + (size_t)b * row_len + t0;
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      if (q < written) *reinterpret_cast<uint2*>(dst + q * plane) = make_uint2(w[0][q], w[1][q]);
  }
}

// clean, denoised (batch, t_len) float32; out (2 kPieces, batch, row_len)
// bf16, 16-byte aligned; row_len >= t_len, row_len % 8 == 0; rest false:
// the x0 planes only; scale_partial (batch, kScaleSplits, 2), read only
// when kScaleSplits > 0
template <int kPieces = 2, int kScaleSplits = 0>
inline cudaError_t split(const float* c, const float* d, void* out, long long t_len, long long row_len, int batch,
                         bool rest, cudaStream_t stream, const float* scale_partial = nullptr, float eps = 0.f) {
  if (row_len % 8 || row_len < t_len || batch <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int vec = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const long long per_block = (long long)kThreads * kPer;
  const dim3 grid((unsigned)((row_len + per_block - 1) / per_block), batch);
  split_kernel<kPieces, kScaleSplits><<<grid, kThreads, 0, stream>>>(
      c, d, scale_partial, static_cast<__nv_bfloat16*>(out), t_len, row_len, batch, rest ? kPieces : 1, vec, eps);
  return cudaGetLastError();
}

// grid (ceil(rows ld / (kThreads kPer)), 3): one group of kPer
// columns of one row a thread, neighbouring threads on neighbouring groups
template <int kPieces>
__global__ void __launch_bounds__(kThreads) split_rows_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                                                              const float* __restrict__ x2,
                                                              __nv_bfloat16* __restrict__ out, long long rows, int hd,
                                                              int ld, int vec) {
  const float* x = blockIdx.y == 0 ? x0 : (blockIdx.y == 1 ? x1 : x2);
  const int groups = ld / kPer;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= rows * groups) return;
  const long long r = idx / groups;
  const int c0 = (int)(idx % groups) * kPer;
  const float* src = x + r * hd;
  float v[kPer];
  if (vec && c0 + kPer <= hd) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(src + c0));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = c0 + e < hd ? src[c0 + e] : 0.f;
  }
  uint32_t w[2][kPieces];
#pragma unroll
  for (int e = 0; e < kPer / 2; ++e) split_pair<kPieces>(v[2 * e], v[2 * e + 1], w[e]);
  const size_t plane = (size_t)rows * ld;
  __nv_bfloat16* dst = out + (size_t)blockIdx.y * kPieces * plane + (size_t)r * ld + c0;
#pragma unroll
  for (int q = 0; q < kPieces; ++q) *reinterpret_cast<uint2*>(dst + q * plane) = make_uint2(w[0][q], w[1][q]);
}

// x0, x1, x2 (rows, hd) float32, 16-byte aligned; out (3, kPieces, rows,
// ld) bf16, 16-byte aligned; 0 < hd <= ld, ld % 4 == 0
template <int kPieces>
inline cudaError_t split_rows(const float* x0, const float* x1, const float* x2, void* out, long long rows, int hd,
                              int ld, cudaStream_t stream) {
  if (rows <= 0 || hd <= 0 || hd > ld || ld % kPer) return cudaErrorInvalidValue;
  const long long blocks = (rows * (ld / kPer) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  split_rows_kernel<kPieces><<<dim3((unsigned)blocks, 3), kThreads, 0, stream>>>(
      x0, x1, x2, static_cast<__nv_bfloat16*>(out), rows, hd, ld, hd % 4 == 0);
  return cudaGetLastError();
}

}  // namespace halves
}  // namespace
