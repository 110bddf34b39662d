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
// * attention_kernel: one block of 4 warps per (row, head, tile of 64
//   queries); each warp owns 16 queries. Key tiles of 64 stream through
//   shared memory; S = Q K^T in fp32 by wmma, then per element
//   p = exp2(clamp(s, -100, 60)) (exp2; exp2_bf16 is jnp.exp2 of the
//   bf16-rounded clamped logit, i.e. bf16(exp(bf16(s * bf16(ln 2))))), keys >= T masked to 0, l += p in fp32, bf16(p) staged
//   and ctx += bf16(p) V by wmma, accumulated across key tiles. The exp2
//   softmax is max-free, so one pass needs no rescaling. "exact" runs a
//   first pass over all key tiles for the row max and then
//   p = exp(s - max), so p and its bf16 rounding are the TPU kernel's (an
//   online softmax would round p against a running max). The context is
//   ctx / l rounded to bf16.
// * residual_ln_kernel: one warp per row of d: r = y + bf16(x), mean and
//   centered variance in fp32, r' = (r - mean) rsqrt(var + eps) s + b.
// The (rows x T, 3d) qkv, the context and the (rows x T, ffn) hidden pass
// through device memory between these launches.
#include <cuda_bf16.h>
#include <mma.h>

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

// -- attention ------------------------------------------------------------------

constexpr int kHeadDim = 64;
constexpr int kQTile = 64, kKTile = 64;
constexpr int kAttnWarps = kQTile / 16;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kLdT = kHeadDim + 8;  // bf16 tiles
constexpr int kLdS = kKTile + 4;    // fp32 logits
constexpr int kLdP = kKTile + 8;    // bf16 probabilities
constexpr size_t kAttnSmem = 3 * kQTile * kLdT * sizeof(bf16)       // Q, K, V
                             + kAttnWarps * 16 * kLdS * sizeof(float)  // S per warp
                             + kAttnWarps * 16 * kLdP * sizeof(bf16);  // P per warp

enum Softmax { kExp2 = 0, kExp2Bf16 = 1, kExact = 2 };
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float bf16_round(bf16 v) { return __bfloat162float(v); }


// rows [r0, r0 + 64) of one head's column slice (qkv row stride ld) into a
// (64, kLdT) tile; rows >= t_len are zeros
__device__ __forceinline__ void load_head_tile(bf16* dst, const bf16* src, int r0, int t_len,
                                               int ld, int tid) {
  // 64 rows x 8 uint4
  for (int idx = tid; idx < kQTile * 8; idx += kAttnThreads) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = v;
  }
}

// the warp's 16 x 64 logits of key tile k0 into its S scratch
__device__ __forceinline__ void warp_logits(float* s, const bf16* q, const bf16* k) {
#pragma unroll
  for (int j = 0; j < kKTile / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, q + kk, kLdT);
      wmma::load_matrix_sync(b, k + j * 16 * kLdT + kk, kLdT);  // K^T
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s + j * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// qkv: (rows * t_len, 3 d) bf16, columns [q heads | k heads | v heads];
// ctx: (rows * t_len, d) bf16. grid (query tiles, heads, rows).
template <int kMode>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int t_len, int d) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kQTile * kLdT;
  bf16* vs = ks + kKTile * kLdT;
  float* s_all = reinterpret_cast<float*>(vs + kKTile * kLdT);
  bf16* p_all = reinterpret_cast<bf16*>(s_all + kAttnWarps * 16 * kLdS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, row = blockIdx.z;
  const int ld = 3 * d;
  const bf16* base = qkv + (size_t)row * t_len * ld;
  float* s = s_all + warp * 16 * kLdS;
  bf16* p = p_all + warp * 16 * kLdP;
  const bf16* qw = qs + warp * 16 * kLdT;
  // lane -> (query row r of the warp's 16, key columns c0 .. c0 + 31)
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int n_ktiles = (t_len + kKTile - 1) / kKTile;

  load_head_tile(qs, base + h * kHeadDim, q0, t_len, ld, tid);

  float row_max = 0.f;
  if (kMode == kExact) {  // pass 1: the row max over every valid key
    row_max = -__int_as_float(0x7f800000);  // -inf
    for (int kt = 0; kt < n_ktiles; ++kt) {
      __syncthreads();
      load_head_tile(ks, base + d + h * kHeadDim, kt * kKTile, t_len, ld, tid);
      __syncthreads();
      warp_logits(s, qw, ks);
      __syncwarp();
      for (int c = 0; c < 32; ++c) {
        if (kt * kKTile + c0 + c < t_len) row_max = fmaxf(row_max, s[r * kLdS + c0 + c]);
      }
      __syncwarp();
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(fsem::kFullMask, row_max, 1));
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kHeadDim / 16];
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  float l = 0.f;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    __syncthreads();
    load_head_tile(ks, base + d + h * kHeadDim, kt * kKTile, t_len, ld, tid);
    load_head_tile(vs, base + 2 * d + h * kHeadDim, kt * kKTile, t_len, ld, tid);
    __syncthreads();
    warp_logits(s, qw, ks);
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const float sv = s[r * kLdS + c0 + c];
      float pv = 0.f;
      if (kt * kKTile + c0 + c < t_len) {
        if (kMode == kExact) {
          pv = expf(sv - row_max);
        } else {
          const float cl = fminf(fmaxf(sv, -100.f), 60.f);
          if (kMode == kExp2Bf16) {  // jnp.exp2 on bf16: exp(bf16(s * bf16(ln 2)))
            const float arg = bf16_round(bf16_round(cl) * kLn2Bf16);
            pv = bf16_round(expf(arg));
          } else {
            pv = exp2f(cl);
          }
        }
      }
      l += pv;
      p[r * kLdP + c0 + c] = __float2bfloat16(pv);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKTile; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, p + kk, kLdP);
#pragma unroll
      for (int j = 0; j < kHeadDim / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, vs + kk * kLdT + j * 16, kLdT);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  l += __shfl_xor_sync(fsem::kFullMask, l, 1);

  // ctx / l -> bf16, through the warp's S scratch
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j)
    wmma::store_matrix_sync(s + j * 16, acc[j], kLdS, wmma::mem_row_major);
  __syncwarp();
  const int q = q0 + warp * 16 + r;
  if (q < t_len) {
    bf16* out = ctx + ((size_t)row * t_len + q) * d + h * kHeadDim + c0;
    const float inv = 1.f / l;
    for (int c = 0; c < 32; c += 2) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(s[r * kLdS + c0 + c] * inv,
                                                     s[r * kLdS + c0 + c + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + c) = v;
    }
  }
}

// -- residual + LayerNorm -----------------------------------------------------------

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
  const dim3 grid((t_len + kQTile - 1) / kQTile, heads, rows);
  if (mode == kExp2) {
    err = cudaFuncSetAttribute(attention_kernel<kExp2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmem);
    if (err != cudaSuccess) return (int)err;
    attention_kernel<kExp2><<<grid, kAttnThreads, kAttnSmem, stream>>>(qkv, ctx, t_len, d);
  } else if (mode == kExp2Bf16) {
    err = cudaFuncSetAttribute(attention_kernel<kExp2Bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmem);
    if (err != cudaSuccess) return (int)err;
    attention_kernel<kExp2Bf16><<<grid, kAttnThreads, kAttnSmem, stream>>>(qkv, ctx, t_len, d);
  } else {
    err = cudaFuncSetAttribute(attention_kernel<kExact>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmem);
    if (err != cudaSuccess) return (int)err;
    attention_kernel<kExact><<<grid, kAttnThreads, kAttnSmem, stream>>>(qkv, ctx, t_len, d);
  }
  err = cudaGetLastError();
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
// d / heads == 64; mode 0 exp2, 1 exp2_bf16, 2 exact.
extern "C" int fsem_attn_block(const void* x, const void* wqkv, const float* bqkv,
                               const void* wo, const float* bo, const float* lns,
                               const float* lnb, void* qkv, void* ctx, float* y, void* out,
                               int rows, int t_len, int d, int heads, int mode, int x_bf16,
                               float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d / heads != kHeadDim || d % kBK) return (int)cudaErrorInvalidValue;
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
