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
// which compile to mma.sync; no wgmma or TMA yet):
// * gemm_kernel: C = A B + bias over M = rows x T, one 128 x 128 output
//   tile per block of 8 warps (each 32 x 64), K in steps of 32 through
//   shared memory. A is fp32 (rounded to bf16 as it is staged) or bf16, B
//   is bf16 (K, N) row-major. Rows past M and columns past N load as zeros
//   and are not stored: T need not be a multiple of 16, and nothing is
//   padded in device memory. The epilogue adds the bias and either rounds
//   to bf16 (QKV), applies the tanh GELU in fp32 and rounds to bf16 (FFN
//   W_1), or keeps fp32 (W_o, W_2).
// * attention: attention_core.cuh (shared with A9 / A15), bf16 arm, one
//   block of 4 warps per (row, head, tile of 64 queries), key tiles of 64
//   through shared memory, any head width up to 128 (zero-padded to a
//   multiple of 16), softmax exp2 / exp2_bf16 / exact; ctx / l rounded to
//   bf16.
// * residual_ln_kernel: one warp per row of d: r = y + bf16(x), mean and
//   centered variance in fp32, r' = (r - mean) rsqrt(var + eps) s + b.
// The (rows x T, 3d) qkv, the context and the (rows x T, ffn) hidden pass
// through device memory between these launches.
#include <cuda_bf16.h>
#include <mma.h>

#include "attention_core.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// -- GEMM ---------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8;  // bf16 elements; +8 staggers banks
constexpr int kGemmThreads = 256;

enum Epilogue { kBiasBf16 = 0, kBiasGeluBf16 = 1, kBiasF32 = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

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

// C (M, N) = epilogue(A (M, K) B (K, N) + bias); K % 32 == 0, N % 8 == 0.
template <typename TA, int kEpi, typename TC>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    const TA* __restrict__ A, const bf16* __restrict__ B, const float* __restrict__ bias,
    TC* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[kBM][kLdA];
  __shared__ __align__(128) bf16 Bs[kBK][kLdB];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a_tile<TA>(As, A, m0, k0, M, K, tid);
    load_b_tile(Bs, B, n0, k0, N, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch
  float* cs = Cs[warp];
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

template <typename TA, int kEpi, typename TC>
cudaError_t gemm(const TA* A, const bf16* B, const float* bias, TC* C, int M, int N, int K,
                 cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TA, kEpi, TC><<<grid, kGemmThreads, 0, stream>>>(A, B, bias, C, M, N, K);
  return cudaGetLastError();
}

// -- residual + LayerNorm -----------------------------------------------------------

using attn::bf16_round;
__device__ __forceinline__ float bf16_round(bf16 v) { return __bfloat162float(v); }

constexpr int kLnWarps = 8;

// out[m] = LN(y[m] + bf16(x[m])) over n columns, one warp per row; out in x's type
template <typename TX>
__global__ void __launch_bounds__(kLnWarps * 32) residual_ln_kernel(
    const float* __restrict__ y, const TX* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, TX* __restrict__ out, int M, int n, float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
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
  TX* o = out + (size_t)m * n;
  for (int c = lane; c < n; c += 32) {
    const float v = yr[c] + bf16_round(xr[c]) - mean;
    store_out(o + c, v * inv * scale[c] + shift[c]);
  }
}

template <typename TX>
cudaError_t residual_ln(const float* y, const TX* x, const float* s, const float* b, TX* out,
                        int M, int n, float eps, cudaStream_t stream) {
  residual_ln_kernel<TX><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      y, x, s, b, out, M, n, eps);
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
  const int hd = d / heads;
  attn::Args a{};
  a.q = qkv;
  a.k = qkv + d;
  a.v = qkv + 2 * d;
  a.o = ctx;
  a.row_stride = (long long)t_len * 3 * d;
  a.head_stride = hd;
  a.o_row_stride = (long long)t_len * d;
  a.o_head_stride = hd;
  a.ld = 3 * d;
  a.ld_o = d;
  a.t_len = t_len;
  a.n_keys = t_len;
  a.hd = hd;
  a.scale = 1.f;
  a.l_pad = 0.f;
  a.vec = hd % 8 == 0;
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
