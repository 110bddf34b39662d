// The post-LN attention block with every product in int8 (the screening mode).
//
// Replaces the Pallas TPU kernel ops/attn_block_pallas.py::_attn_block_kernel
// of the JAX package run with quant="int8" (A12): _quant_rows, _quant_cols
// and _dot_i8 inside it. Per row of a (rows, T, d) activation, x's dtype in
// and out:
//   1. x rounded to bf16, quantized per row over d: s = max(max|x| / 127,
//      1e-12), q = round-half-even(x / s) (a division, as the TPU kernel);
//   2. qkv = (acc_i32 sx) sw + b in fp32 (no bf16 rounding), with the int8
//      weights quantized per column from the fp32 folded weights;
//   3. per head, q and k quantized per row over the head width,
//      s = (qq kq^T)_i32 sq sk^T, keys past T masked, p in A7's softmax
//      modes (exp2 clamped to [-100, 60], exp2_bf16, exact), l = sum p;
//   4. pn = p / l first, pq = round(127 pn) in int8; v quantized per column
//      over the keys; ctx = ((pq vq)_i32 / 127) sv in fp32;
//   5. the context quantized per row over d (all heads), out = (cq
//      wo_q)_i32 sc so + bo;
//   6. residual (the bf16-rounded x) and LayerNorm as A7.
// The TPU kernel pads T to a multiple of 8 with zero rows, whose qkv is the
// bias; so when T % 8 != 0, v's column scale also covers |b_v|. This kernel
// pads nothing and adds that term. Every dequantizing product and sum is
// written with __fmul_rn / __fadd_rn / __fdiv_rn, so none is fused into an
// FMA: the integer products are exact, and the scales and the values they
// quantize are the plain version's, bit for bit, up to the softmax.
//
// What bounds it on this card: operations, about 0.37 T int8 operations
// per launch at mHuBERT-147's width and 64 rows of 799 frames (0.19 ms at
// 1979 TOP/s dense int8), against about 0.2 GB of bytes (0.06 ms).
//
// Design (simple first: nvcuda::wmma 16x16x16 signed char fragments with
// int32 accumulation, which compile to mma.sync; int8 tiles are kept in
// shared memory as 16-byte k-chunks, [k / 16][row][16], so that every
// fragment starts 256-bit aligned), nine launches:
// * quant_rows_kernel: one warp per (row, segment): x over d; q and k over
//   each head's width; the context over d;
// * gemm_i8_kernel: C = (acc sA) sB + bias over 128 x 128 tiles, 8 warps,
//   K in steps of 32; weights in (out, in) layout (col-major B fragments);
// * v_scale_kernel / v_quant_kernel: v's column scales per row, then v;
// * attention_i8_kernel: one block of 4 warps per (row, head, 64 queries);
//   pn needs l before any P tile is quantized, so the key tiles are walked
//   twice in the exp2 modes (l, then p, pq and the int32 P V product) and
//   three times in the exact mode (the row max first);
// * block_tiles.cuh's residual_ln_kernel, as A7.
#include <cuda_bf16.h>
#include <mma.h>

#include "attention_core.cuh"
#include "block_tiles.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using i8 = signed char;
using namespace nvcuda;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(fsem::kFullMask, v, o));
  return v;
}

// the int8 scale of a slice whose largest magnitude is amax
__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f); }

__device__ __forceinline__ i8 quantize(float v, float s) { return (i8)__float2int_rn(__fdiv_rn(v, s)); }

// -- per-row quantization ------------------------------------------------------

constexpr int kRowWarps = 8;

// one warp per (row m, segment g): in[m, g w .. g w + w) -> q (same place),
// scale[m, g]; kRound: round the input to bf16 first (x)
template <typename TIn, bool kRound>
__global__ void __launch_bounds__(kRowWarps * 32) quant_rows_kernel(
    const TIn* __restrict__ in, int ld, int width, int n_seg, i8* __restrict__ q,
    float* __restrict__ scale, int M) {
  const int gw = blockIdx.x * kRowWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int m = gw / n_seg, g = gw % n_seg;
  if (m >= M) return;
  const TIn* src = in + (size_t)m * ld + (size_t)g * width;
  i8* dst = q + (size_t)m * ld + (size_t)g * width;
  float amax = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float v = kRound ? tiles::bf16_round(to_f32(src[c])) : to_f32(src[c]);
    amax = fmaxf(amax, fabsf(v));
  }
  const float s = quant_scale(warp_max(amax));
  for (int c = lane; c < width; c += 32) {
    const float v = kRound ? tiles::bf16_round(to_f32(src[c])) : to_f32(src[c]);
    dst[c] = quantize(v, s);
  }
  if (lane == 0) scale[(size_t)m * n_seg + g] = s;
}

template <typename TIn, bool kRound>
cudaError_t quant_rows(const TIn* in, int ld, int width, int n_seg, i8* q, float* scale, int M,
                       cudaStream_t stream) {
  const long long warps = (long long)M * n_seg;
  quant_rows_kernel<TIn, kRound><<<(unsigned)((warps + kRowWarps - 1) / kRowWarps), kRowWarps * 32, 0,
                                   stream>>>(in, ld, width, n_seg, q, scale, M);
  return cudaGetLastError();
}

// -- v: per-column scales over the keys of each row, then v -------------------------

// thread per (row, column c of v): max over the row's T keys of |v|, and
// |b_v| when the TPU kernel's padding rows exist (T % 8 != 0)
__global__ void __launch_bounds__(256) v_scale_kernel(const float* __restrict__ qkv,
                                                      const float* __restrict__ b_v,
                                                      float* __restrict__ s_v, int t_len, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, row = blockIdx.y;
  if (c >= d) return;
  const float* col = qkv + (size_t)row * t_len * 3 * d + 2 * d + c;
  float amax = 0.f;
  for (int t = 0; t < t_len; ++t) amax = fmaxf(amax, fabsf(col[(size_t)t * 3 * d]));
  if (t_len % 8) amax = fmaxf(amax, fabsf(b_v[c]));
  s_v[(size_t)row * d + c] = quant_scale(amax);
}

__global__ void __launch_bounds__(256) v_quant_kernel(const float* __restrict__ qkv,
                                                      const float* __restrict__ s_v,
                                                      i8* __restrict__ qkv_q, long long n, int t_len,
                                                      int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = i / d;
  const int c = (int)(i % d);
  const size_t at = (size_t)m * 3 * d + 2 * d + c;
  qkv_q[at] = quantize(qkv[at], s_v[(size_t)(m / t_len) * d + c]);
}

// -- int8 GEMM with a dequantizing epilogue -------------------------------------------

constexpr int kQBM = 128, kQBN = 128, kQBK = 32, kQThreads = 256;

struct I8GemmSmem {
  i8 As[kQBK / 16][kQBM][16];  // A tile as 16-byte k-chunks
  i8 Bs[kQBK / 16][kQBN][16];  // B^T tile likewise
  int Cs[kQThreads / 32][16 * 16];
};

// C (M, N) fp32 = (acc sa[m]) sb[n] + bias[n], acc = A (M, K) B (K, N) in
// int32, B given as Bt (N, K) row-major; K % 32 == 0
__global__ void __launch_bounds__(kQThreads) gemm_i8_kernel(
    const i8* __restrict__ A, const i8* __restrict__ Bt, const float* __restrict__ sa,
    const float* __restrict__ sb, const float* __restrict__ bias, float* __restrict__ C, int M, int N,
    int K) {
  __shared__ __align__(128) I8GemmSmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kQBM, n0 = blockIdx.x * kQBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int r = tid >> 1, kc = tid & 1;  // one 16-byte chunk of A and of B per thread
  for (int k0 = 0; k0 < K; k0 += kQBK) {
    uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
    if (m0 + r < M) va = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + kc * 16);
    if (n0 + r < N) vb = *reinterpret_cast<const uint4*>(Bt + (size_t)(n0 + r) * K + k0 + kc * 16);
    *reinterpret_cast<uint4*>(&sm.As[kc][r][0]) = va;
    *reinterpret_cast<uint4*>(&sm.Bs[kc][r][0]) = vb;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kQBK / 16; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, i8, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, i8, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &sm.As[c][wm + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &sm.Bs[c][wn + j * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  int* cs = sm.Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = lane >> 1, c0 = (lane & 1) * 8;
      const int m = m0 + wm + i * 16 + rr;
      if (m < M) {
        const float s_m = sa[m];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + wn + j * 16 + c0 + e;
          if (n < N) {
            const float v = __fmul_rn(__fmul_rn(__int2float_rn(cs[rr * 16 + c0 + e]), s_m), sb[n]);
            C[(size_t)m * N + n] = __fadd_rn(v, bias[n]);
          }
        }
      }
      __syncwarp();
    }
}

cudaError_t gemm_i8(const i8* A, const i8* Bt, const float* sa, const float* sb, const float* bias,
                    float* C, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kQBN - 1) / kQBN, (M + kQBM - 1) / kQBM);
  gemm_i8_kernel<<<grid, kQThreads, 0, stream>>>(A, Bt, sa, sb, bias, C, M, N, K);
  return cudaGetLastError();
}

// -- int8 attention -------------------------------------------------------------------

constexpr int kAQ = 64, kAWarps = 4, kAThreads = kAWarps * 32, kAKeys = 64;

struct I8Args {
  const i8* qkv_q;   // (rows T, 3 d): q, k quantized per row and head, v per column
  const float* s_qk;  // (rows T, 2 heads): q scales, then k scales
  const float* s_v;   // (rows, d)
  float* ctx;         // (rows T, d)
  int t_len, d, heads;
};

template <int HDP>
struct I8Shape {
  static constexpr int LDI = (HDP > kAKeys ? HDP : kAKeys) + 4;  // int32 scratch row
  static constexpr size_t kTile = (size_t)kAQ * HDP;              // bytes of one int8 tile
  static constexpr size_t kS = (size_t)kAWarps * 16 * LDI * sizeof(int);
  static constexpr size_t kP = (size_t)kAWarps * (kAKeys / 16) * 16 * 16;
  static constexpr size_t kSmem = 3 * kTile + kS + kP + (2 * kAQ + HDP) * sizeof(float);
  static_assert(HDP % 16 == 0 && HDP <= attn::kMaxHead, "head width");
};

// rows r0 .. r0 + 63 of one head (frame stride ld, width hd) into a
// [HDP / 16][64][16] tile; rows >= t_len and columns >= hd are zeros
template <int HDP>
__device__ __forceinline__ void load_i8_tile(i8* dst, const i8* src, int r0, int t_len, int ld, int hd,
                                             bool vec, int tid) {
  constexpr int kChunks = HDP / 16;
  if (vec) {  // hd, ld and the head offsets are multiples of 16 bytes
    for (int idx = tid; idx < kAQ * kChunks; idx += kAThreads) {
      const int r = idx / kChunks, j = idx % kChunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < t_len && j * 16 < hd) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + j * 16);
      *reinterpret_cast<uint4*>(dst + (j * kAQ + r) * 16) = v;
    }
  } else {
    for (int idx = tid; idx < kAQ * HDP; idx += kAThreads) {
      const int r = idx / HDP, c = idx % HDP;
      i8 v = 0;
      if (r0 + r < t_len && c < hd) v = src[(size_t)(r0 + r) * ld + c];
      dst[((c >> 4) * kAQ + r) * 16 + (c & 15)] = v;
    }
  }
}

template <int kMode>
__device__ __forceinline__ float probability(float s, float row_max) {
  if constexpr (kMode == attn::kExact) {
    return expf(s - row_max);
  } else {
    const float cl = fminf(fmaxf(s, -100.f), 60.f);
    if constexpr (kMode == attn::kExp2Bf16) {
      return attn::bf16_round(expf(attn::bf16_round(attn::bf16_round(cl) * attn::kLn2Bf16)));
    } else {
      return exp2f(cl);
    }
  }
}

template <int HDP, int kMode>
__global__ void __launch_bounds__(kAThreads) attention_i8_kernel(I8Args a) {
  using Sh = I8Shape<HDP>;
  constexpr int LDI = Sh::LDI;
  extern __shared__ __align__(128) unsigned char smem[];
  i8* qs = reinterpret_cast<i8*>(smem);
  i8* ks = qs + Sh::kTile;
  i8* vs = ks + Sh::kTile;
  int* s_all = reinterpret_cast<int*>(smem + 3 * Sh::kTile);
  i8* p_all = reinterpret_cast<i8*>(smem + 3 * Sh::kTile + Sh::kS);
  float* sq_s = reinterpret_cast<float*>(smem + 3 * Sh::kTile + Sh::kS + Sh::kP);
  float* sk_s = sq_s + kAQ;
  float* sv_s = sk_s + kAKeys;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kAQ, h = blockIdx.y, row = blockIdx.z;
  const int t_len = a.t_len, d = a.d, heads = a.heads, hd = d / heads, ld = 3 * d;
  const size_t row0 = (size_t)row * t_len;
  const i8* qb = a.qkv_q + row0 * ld + (size_t)h * hd;
  const i8* kb = qb + d;
  const i8* vb = qb + 2 * d;
  const float* sqk = a.s_qk + row0 * 2 * heads;
  const bool vec = hd % 16 == 0;
  int* s = s_all + warp * 16 * LDI;
  i8* p = p_all + warp * (kAKeys / 16) * 256;
  const int r = lane >> 1, c0 = (lane & 1) * (kAKeys / 2);  // query row, key columns of the lane
  const int n_kt = (t_len + kAKeys - 1) / kAKeys;
  const float kNegInf = -__int_as_float(0x7f800000);

  load_i8_tile<HDP>(qs, qb, q0, t_len, ld, hd, vec, tid);
  if (tid < kAQ) sq_s[tid] = q0 + tid < t_len ? sqk[(size_t)(q0 + tid) * 2 * heads + h] : 0.f;
  for (int c = tid; c < HDP; c += kAThreads) sv_s[c] = c < hd ? a.s_v[(size_t)row * d + h * hd + c] : 0.f;

  // the warp's 16 x 64 int32 logits of key tile kt (in ks) into s
  auto logits = [&]() {
#pragma unroll
    for (int j = 0; j < kAKeys / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, i8, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, i8, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + (kk * kAQ + warp * 16) * 16, 16);
        wmma::load_matrix_sync(fb, ks + (kk * kAQ + j * 16) * 16, 16);  // K^T
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(s + j * 16, acc, LDI, wmma::mem_row_major);
    }
    __syncwarp();
  };
  auto load_keys = [&](int kt, bool with_v) {
    __syncthreads();
    load_i8_tile<HDP>(ks, kb, kt * kAKeys, t_len, ld, hd, vec, tid);
    if (with_v) load_i8_tile<HDP>(vs, vb, kt * kAKeys, t_len, ld, hd, vec, tid);
    if (tid < kAKeys) {
      const int key = kt * kAKeys + tid;
      sk_s[tid] = key < t_len ? sqk[(size_t)key * 2 * heads + heads + h] : 0.f;
    }
    __syncthreads();
  };
  // dequantized logit of the lane's key column c of the current tile (the
  // scales are read after load_keys' barriers)
  auto logit = [&](int c) {
    return __fmul_rn(__fmul_rn(__int2float_rn(s[r * LDI + c0 + c]), sq_s[warp * 16 + r]), sk_s[c0 + c]);
  };

  float row_max = 0.f;
  if constexpr (kMode == attn::kExact) {  // pass 1: the row max over every valid key
    row_max = kNegInf;
    for (int kt = 0; kt < n_kt; ++kt) {
      load_keys(kt, false);
      logits();
      for (int c = 0; c < kAKeys / 2; ++c) {
        if (kt * kAKeys + c0 + c < t_len) row_max = fmaxf(row_max, logit(c));
      }
      __syncwarp();
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(fsem::kFullMask, row_max, 1));
  }

  float l = 0.f;  // pass 2: the row sum (the lane's half, then the row's)
  for (int kt = 0; kt < n_kt; ++kt) {
    load_keys(kt, false);
    logits();
    for (int c = 0; c < kAKeys / 2; ++c) {
      if (kt * kAKeys + c0 + c < t_len) l += probability<kMode>(logit(c), row_max);
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(fsem::kFullMask, l, 1);

  // pass 3: pq = round(127 p / l) in int8, ctx_i32 = pq vq
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[HDP / 16];
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) wmma::fill_fragment(acc[j], 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    load_keys(kt, true);
    logits();
    for (int c = 0; c < kAKeys / 2; ++c) {
      const int col = c0 + c;
      int pq = 0;
      if (kt * kAKeys + col < t_len) {
        pq = __float2int_rn(__fmul_rn(__fdiv_rn(probability<kMode>(logit(c), row_max), l), 127.f));
      }
      p[(col >> 4) * 256 + r * 16 + (col & 15)] = (i8)pq;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kAKeys / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, i8, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, p + kk * 256, 16);
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, i8, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, vs + (j * kAQ + kk * 16) * 16, 16);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncwarp();
  }

  // ctx = (acc / 127) sv, fp32
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) wmma::store_matrix_sync(s + j * 16, acc[j], LDI, wmma::mem_row_major);
  __syncwarp();
  const int q = q0 + warp * 16 + r;
  if (q < t_len) {
    float* out = a.ctx + (row0 + q) * d + (size_t)h * hd;
    const int oc0 = (lane & 1) * (HDP / 2);
    for (int c = oc0; c < oc0 + HDP / 2 && c < hd; ++c) {
      out[c] = __fmul_rn(__fdiv_rn(__int2float_rn(s[r * LDI + c]), 127.f), sv_s[c]);
    }
  }
}

template <int HDP, int kMode>
cudaError_t launch_attention(const I8Args& a, int rows, cudaStream_t stream) {
  constexpr size_t smem = I8Shape<HDP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_i8_kernel<HDP, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kAQ - 1) / kAQ, a.heads, rows);
  attention_i8_kernel<HDP, kMode><<<grid, kAThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_any_width(const I8Args& a, int rows, cudaStream_t stream) {
  switch ((a.d / a.heads + 15) / 16) {
    case 1: return launch_attention<16, kMode>(a, rows, stream);
    case 2: return launch_attention<32, kMode>(a, rows, stream);
    case 3: return launch_attention<48, kMode>(a, rows, stream);
    case 4: return launch_attention<64, kMode>(a, rows, stream);
    case 5: return launch_attention<80, kMode>(a, rows, stream);
    case 6: return launch_attention<96, kMode>(a, rows, stream);
    case 7: return launch_attention<112, kMode>(a, rows, stream);
    case 8: return launch_attention<128, kMode>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- the block ------------------------------------------------------------------------

struct I8Block {
  const void* x;
  const i8 *wq_t, *wo_t;
  const float *bq2, *bo2, *lns, *lnb;  // bq2 = [bqkv; column scales], bo2 likewise
  i8 *row_q, *qkv_q;
  float *s_row, *qkv, *s_qk, *s_v, *ctx, *y;
  void* out;
  int rows, t_len, d, heads, mode;
  float eps;
};

template <typename TX>
int attn_block_int8(const I8Block& b, cudaStream_t stream) {
  const int M = b.rows * b.t_len, d = b.d, hd = d / b.heads;
  const TX* x = static_cast<const TX*>(b.x);
  cudaError_t err = quant_rows<TX, true>(x, d, d, 1, b.row_q, b.s_row, M, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_i8(b.row_q, b.wq_t, b.s_row, b.bq2 + 3 * d, b.bq2, b.qkv, M, 3 * d, d, stream);
  if (err != cudaSuccess) return (int)err;
  // q and k: 2 heads segments of hd per row, in the (M, 3 d) layout
  err = quant_rows<float, false>(b.qkv, 3 * d, hd, 2 * b.heads, b.qkv_q, b.s_qk, M, stream);
  if (err != cudaSuccess) return (int)err;
  v_scale_kernel<<<dim3((d + 255) / 256, b.rows), 256, 0, stream>>>(b.qkv, b.bq2 + 2 * d, b.s_v, b.t_len, d);
  const long long n_v = (long long)M * d;
  v_quant_kernel<<<(unsigned)((n_v + 255) / 256), 256, 0, stream>>>(b.qkv, b.s_v, b.qkv_q, n_v, b.t_len, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  I8Args a{b.qkv_q, b.s_qk, b.s_v, b.ctx, b.t_len, d, b.heads};
  switch (b.mode) {
    case attn::kExp2: err = launch_any_width<attn::kExp2>(a, b.rows, stream); break;
    case attn::kExp2Bf16: err = launch_any_width<attn::kExp2Bf16>(a, b.rows, stream); break;
    case attn::kExact: err = launch_any_width<attn::kExact>(a, b.rows, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = quant_rows<float, false>(b.ctx, d, d, 1, b.row_q, b.s_row, M, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_i8(b.row_q, b.wo_t, b.s_row, b.bo2 + d, b.bo2, b.y, M, d, d, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)tiles::residual_ln<TX>(b.y, x, b.lns, b.lnb, static_cast<TX*>(b.out), M, d, b.eps, stream);
}

}  // namespace

// A12. x, out: (rows, t_len, d), both fp32 or both bf16 (x_bf16); wq_t:
// (3 d, d) int8, the folded [q | k | v] weights quantized per column and
// transposed; bq2: (2, 3 d) fp32, the bias and the column scales; wo_t:
// (d, d) int8 likewise, bo2 (2, d); lns, lnb: (d,) fp32. Scratch: row_q
// (rows t_len, d) int8, s_row (rows t_len,), qkv (rows t_len, 3 d) fp32,
// qkv_q (rows t_len, 3 d) int8, s_qk (rows t_len, 2 heads), s_v (rows, d),
// ctx and y (rows t_len, d) fp32. d % 32 == 0, d / heads <= 128; mode 0
// exp2, 1 exp2_bf16, 2 exact.
extern "C" int fsem_attn_block_int8(const void* x, const void* wq_t, const float* bq2, const void* wo_t,
                                    const float* bo2, const float* lns, const float* lnb, void* row_q,
                                    float* s_row, float* qkv, void* qkv_q, float* s_qk, float* s_v,
                                    float* ctx, float* y, void* out, int rows, int t_len, int d,
                                    int heads, int mode, int x_bf16, float eps, void* stream_ptr) {
  if (heads <= 0 || d % heads || d / heads > attn::kMaxHead || d % 32) return (int)cudaErrorInvalidValue;
  I8Block b{x, static_cast<const i8*>(wq_t), static_cast<const i8*>(wo_t), bq2, bo2, lns, lnb,
            static_cast<i8*>(row_q), static_cast<i8*>(qkv_q), s_row, qkv, s_qk, s_v, ctx, y, out,
            rows, t_len, d, heads, mode, eps};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return x_bf16 ? attn_block_int8<bf16>(b, stream) : attn_block_int8<float>(b, stream);
}
