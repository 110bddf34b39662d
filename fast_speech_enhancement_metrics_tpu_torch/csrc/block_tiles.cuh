// Tile routines of the post-LN encoder blocks: A11 (layer_block.cu) runs
// them all inside one persistent launch; A7 / A8 (attn_block.cu) and A12
// take residual_ln_kernel, their products are gemm_sm90.cuh's.
//
// * gemm_tile: one 128 x 128 output tile of C = epilogue(A B + bias) by
//   256 threads (8 warps of 32 x 64, nvcuda::wmma 16x16x16 bf16 fragments
//   with fp32 accumulation), K in steps of 32 through shared memory. A is
//   fp32 (rounded to bf16 as it is staged) or bf16, B is bf16 (K, N)
//   row-major. Rows past M and columns past N load as zeros and are not
//   stored. The epilogue adds the bias and either rounds to bf16 (QKV),
//   applies the tanh GELU in fp32 and rounds to bf16 (FFN W_1), or keeps
//   fp32 (W_o, W_2).
// * residual_ln_row: one warp per row of d: r = y + bf16(x), mean and
//   centered variance in fp32, r' = (r - mean) rsqrt(var + eps) s + b;
//   residual_ln_kernel runs it over all rows in one launch (A7, A8, A12).
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {
namespace tiles {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8;  // bf16 elements; +8 staggers banks
constexpr int kGemmThreads = 256;

enum Epilogue { kBiasBf16 = 0, kBiasGeluBf16 = 1, kBiasF32 = 2 };

struct GemmSmem {
  bf16 As[kBM][kLdA];
  bf16 Bs[kBK][kLdB];
  float Cs[kGemmThreads / 32][16 * 16];
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float bf16_round(bf16 v) { return __bfloat162float(v); }

// 4 consecutive A values -> 4 bf16 in shared memory
__device__ __forceinline__ void stage_a(bf16* dst, const float* src, bool ok) {
  float4 v = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename TA>
__device__ __forceinline__ void load_a_tile(bf16 (*As)[kLdA], const TA* A, int m0, int k0,
                                            int M, int K, int tid);

template <>
__device__ __forceinline__ void load_a_tile<float>(bf16 (*As)[kLdA], const float* A, int m0,
                                                   int k0, int M, int K, int tid) {
  // 128 x 32 floats = 1024 float4, 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kGemmThreads;
    const int r = idx >> 3, c = (idx & 7) * 4;
    const int m = m0 + r;
    stage_a(&As[r][c], A + (size_t)m * K + k0 + c, m < M);
  }
}

template <>
__device__ __forceinline__ void load_a_tile<bf16>(bf16 (*As)[kLdA], const bf16* A, int m0,
                                                  int k0, int M, int K, int tid) {
  // 128 x 32 bf16 = 512 uint4, 2 per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kGemmThreads;
    const int r = idx >> 2, c = (idx & 3) * 8;
    const int m = m0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) v = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + c);
    *reinterpret_cast<uint4*>(&As[r][c]) = v;
  }
}

__device__ __forceinline__ void load_b_tile(bf16 (*Bs)[kLdB], const bf16* B, int n0, int k0,
                                            int N, int tid) {
  // 32 x 128 bf16 = 512 uint4, 2 per thread; N % 8 == 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kGemmThreads;
    const int r = idx >> 4, c = (idx & 15) * 8;
    const int n = n0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) v = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n);
    *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
  }
}

// Output tile (m_tile, n_tile) of C (M, N) = epilogue(A (M, K) B (K, N) +
// bias); K % 32 == 0, N % 8 == 0. All 256 threads of the block take part.
template <typename TA, int kEpi, typename TC>
__device__ __forceinline__ void gemm_tile(const TA* __restrict__ A, const bf16* __restrict__ B,
                                          const float* __restrict__ bias, TC* __restrict__ C,
                                          int M, int N, int K, int m_tile, int n_tile,
                                          GemmSmem& sm, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = m_tile * kBM, n0 = n_tile * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a_tile<TA>(sm.As, A, m0, k0, M, K, tid);
    load_b_tile(sm.Bs, B, n0, k0, N, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &sm.As[wm + i * 16][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &sm.Bs[kk][wn + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch
  float* cs = sm.Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1, c0 = (lane & 1) * 8;
      const int m = m0 + wm + i * 16 + r;
      const int nb = n0 + wn + j * 16 + c0;
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = nb + e;
          if (n < N) {
            float v = cs[r * 16 + c0 + e] + bias[n];
            if (kEpi == kBiasGeluBf16) v = gelu_tanh(v);
            store_out(C + (size_t)m * N + n, v);
          }
        }
      }
      __syncwarp();
    }
}

// out[m] = LN(y[m] + bf16(x[m])) over n columns by one warp; out in TO (x's
// type, unless x is already its bf16 copy)
template <typename TX, typename TO = TX>
__device__ __forceinline__ void residual_ln_row(const float* __restrict__ y, const TX* __restrict__ x,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ shift, TO* __restrict__ out,
                                                int m, int n, float eps, int lane) {
  const float* yr = y + (size_t)m * n;
  const TX* xr = x + (size_t)m * n;
  float sum = 0.f;
  for (int c = lane; c < n; c += 32) sum += yr[c] + bf16_round(xr[c]);
  const float mean = fsem::warp_sum(sum) / (float)n;
  float sq = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float v = yr[c] + bf16_round(xr[c]) - mean;
    sq = fmaf(v, v, sq);
  }
  const float inv = rsqrtf(fsem::warp_sum(sq) / (float)n + eps);
  TO* o = out + (size_t)m * n;
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
