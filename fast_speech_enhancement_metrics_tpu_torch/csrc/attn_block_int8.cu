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
// Each "/ 127" of the TPU kernel is computed as XLA compiles it, a product
// with 1 / 127 rounded to fp32 (the activations' scales, the P V
// dequantization). The TPU kernel pads T to a multiple of 8 with zero
// rows, whose qkv is the bias; so when T % 8 != 0, v's column scale also
// covers |b_v|. This kernel pads nothing and adds that term. Every
// dequantizing product and sum is written with __fmul_rn / __fadd_rn, so
// none is fused into an FMA, and every division (x / s, p / l) rounds as
// __fdiv_rn (common.cuh's div_rn): the integer products are exact, and the
// scales and the values they quantize are the plain version's, bit for
// bit, up to the softmax (l is summed in another order).
//
// What bounds it on this card: operations, about 0.37 T int8 operations
// per launch at mHuBERT-147's width and 64 rows of 799 frames (0.19 ms at
// 1979 TOP/s dense int8), against about 0.2 GB of bytes (0.06 ms). Beside
// the products, the softmax's scalar work sets the attention's time: per
// logit and walk a dequantization (2 fmul) and an exponential on the SFU,
// and in the last walk a division and a rounding. No per-element branch
// splits a row (div_rn, the masking by selection).
//
// Design, on Hopper's TMA and int8 wgmma (sm90.cuh), nine launches:
// * quant_rows_kernel: one warp per row, x (rounded to bf16) over d, later
//   the context over d;
// * gemm_sm90.cuh's int8 arm: qkv = ((x_q wq_t^T) sx) sw + b, then the W_o
//   product, the dequantization in the epilogue;
// * qk_quant_vec_kernel (heads of 16, 32, 64 or 128) or qk_quant_kernel
//   (any width): q and k per row over the head, written head-major,
//   (rows, heads, T, hd16) zero-padded to 16 bytes (TMA's stride rule),
//   their scales as (rows, heads, T128);
// * v_scale_kernel, then vt_quant_kernel: v's column scales over the keys
//   of each row, then v written transposed, (rows, heads, hd, T16) with
//   the keys contiguous: 8-bit wgmma has no transpose bit, so P V's B
//   operand must be K-major, keys inside a row. Within each 32 keys the
//   order is permuted (vt_pos) so that the s32 accumulator of S = Q K^T,
//   whose thread holds keys 8 j + 2 c, 8 j + 2 c + 1, packs into the int8
//   A fragments of P V without shuffles (a fragment register holds k 4 c ..
//   4 c + 3: here keys 2 c, 2 c + 1, 2 c + 8, 2 c + 9);
// * i8_attention_kernel: flash_sm90.cuh's block shape: 128 queries of one
//   (row, head), two consumer warpgroups of 64 query rows at 240 registers,
//   a producer warpgroup at 24 whose one thread loads Q once and keeps TMA
//   loads of K (and in the last walk V^T) tiles of 128 keys in flight in a
//   ring of stages. pn needs l before any P is quantized, so the block
//   walks the keys twice in the exp2 modes (l, then pq and P V) and three
//   times in exact (the row max first); each walk recomputes S = Q K^T
//   from shared memory (wgmma m64n128k32 s8, the logits dequantized in
//   registers) and P V runs on wgmma m64nHDk32 with P from registers;
// * block_tiles.cuh's residual_ln_kernel, as A7.
#include <cuda_bf16.h>

#include "block_tiles.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace {

namespace gemm90 {

// C (M, N) fp32 = ((A Bt^T)_s32 sa[m]) sb[n] + bias[n], A (M, K) and Bt (N, K)
// int8: gemm_sm90.cuh's int8 arm, instantiated in this translation unit only
inline cudaError_t gemm_i8(const int8_t* A, const int8_t* Bt, const float* sa, const float* sb, const float* bias,
                           float* C, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 16) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  if (!tensor_map(&ta, A, 2, a_dims, strides, kBM, 1) || !tensor_map(&tb, Bt, 2, b_dims, strides, kBN, 1))
    return cudaErrorInvalidValue;
  return launch<kDequantF32>(ta, tb, sa, sb, bias, C, M, N, K, stream);
}

}  // namespace gemm90

using bf16 = __nv_bfloat16;
using i8 = signed char;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(fsem::kFullMask, v, o));
  return v;
}

// 1 / 127 in fp32: the TPU kernel's divisions by 127 as XLA compiles them
// (a product with the constant's reciprocal)
constexpr float kInv127 = 1.f / 127.f;

// the int8 scale of an activation slice whose largest magnitude is amax
__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(__fmul_rn(amax, kInv127), 1e-12f); }

// round-half-even(v / s) in int8, r = __frcp_rn(s)
__device__ __forceinline__ i8 quantize(float v, float s, float r) {
  return (i8)__float2int_rn(fsem::div_rn(v, s, r));
}

constexpr int kRowWarps = 8;

// -- x and the context: per-row quantization over d ------------------------------

// one warp per row m: in[m, 0 .. d) -> q[m], scale[m]; kRound: round the
// input to bf16 first (x)
template <typename TIn, bool kRound>
__global__ void __launch_bounds__(kRowWarps * 32) quant_rows_kernel(const TIn* __restrict__ in, int d,
                                                                    i8* __restrict__ q, float* __restrict__ scale,
                                                                    int M) {
  const int m = blockIdx.x * kRowWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const TIn* src = in + (size_t)m * d;
  i8* dst = q + (size_t)m * d;
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = kRound ? tiles::bf16_round(to_f32(src[c])) : to_f32(src[c]);
    amax = fmaxf(amax, fabsf(v));
  }
  const float s = quant_scale(warp_max(amax)), r = __frcp_rn(s);
  for (int c = lane; c < d; c += 32) {
    const float v = kRound ? tiles::bf16_round(to_f32(src[c])) : to_f32(src[c]);
    dst[c] = quantize(v, s, r);
  }
  if (lane == 0) scale[m] = s;
}

template <typename TIn, bool kRound>
cudaError_t quant_rows(const TIn* in, int d, i8* q, float* scale, int M, cudaStream_t stream) {
  quant_rows_kernel<TIn, kRound><<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, stream>>>(in, d, q, scale, M);
  return cudaGetLastError();
}

// -- q and k: per (frame, head) over the head width, written head-major ----------

// Where q and k go: qk_q[part][row][head][t][0 .. hp) int8 (part 0 q, 1 k;
// hp = hd rounded up to 16, zeros past hd), s_qk[part][row][head][t] fp32
// with t_pad (T rounded up to 128) frames a head
struct QkLayout {
  int rows, t_len, heads, hd, hp, t_pad;
  __host__ __device__ size_t q_part() const { return (size_t)rows * heads * t_len * hp; }
  __host__ __device__ size_t s_part() const { return (size_t)rows * heads * t_pad; }
};

// one warp per (frame m, part, head): qkv[m, part d + h hd .. + hd); any hd
__global__ void __launch_bounds__(kRowWarps * 32) qk_quant_kernel(const float* __restrict__ qkv, QkLayout lay,
                                                                  i8* __restrict__ qk_q, float* __restrict__ s_qk) {
  const int gw = blockIdx.x * kRowWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int h = gw % lay.heads, part = (gw / lay.heads) % 2, m = gw / (2 * lay.heads);
  if (m >= lay.rows * lay.t_len) return;
  const int row = m / lay.t_len, t = m % lay.t_len, d = lay.heads * lay.hd;
  const float* src = qkv + (size_t)m * 3 * d + part * d + h * lay.hd;
  float amax = 0.f;
  for (int c = lane; c < lay.hd; c += 32) amax = fmaxf(amax, fabsf(src[c]));
  const float s = quant_scale(warp_max(amax)), r = __frcp_rn(s);
  const size_t rh = (size_t)row * lay.heads + h;
  i8* dst = qk_q + part * lay.q_part() + (rh * lay.t_len + t) * lay.hp;
  for (int c = lane; c < lay.hp; c += 32) dst[c] = c < lay.hd ? quantize(src[c], s, r) : (i8)0;
  if (lane == 0) s_qk[part * lay.s_part() + rh * lay.t_pad + t] = s;
}

// The same for hd a power of two from 16 to 128 (HuBERT base and large)
// and d <= 1024, one warp per (frame m, part): lane l takes floats 4 (l +
// 32 i) .. + 3 of the row, one 16-byte load per 128 floats, all of them in
// flight together; the hd / 4 lanes of a head reduce its max by shuffles
constexpr int kQkVec = 8;  // 16-byte loads a lane
__global__ void __launch_bounds__(kRowWarps * 32) qk_quant_vec_kernel(const float* __restrict__ qkv, QkLayout lay,
                                                                      i8* __restrict__ qk_q,
                                                                      float* __restrict__ s_qk) {
  const int gw = blockIdx.x * kRowWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int m = gw / 2, part = gw % 2;
  if (m >= lay.rows * lay.t_len) return;
  const int row = m / lay.t_len, t = m % lay.t_len, hd = lay.hd, d = lay.heads * hd, n4 = d / 4;
  const float4* src = reinterpret_cast<const float4*>(qkv + (size_t)m * 3 * d + part * d);
  float4 v[kQkVec];
#pragma unroll
  for (int i = 0; i < kQkVec; ++i) {
    const int c4 = lane + 32 * i;
    v[i] = c4 < n4 ? src[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kQkVec; ++i) {
    if (32 * i >= n4) break;  // warp-uniform
    float a = fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)), fmaxf(fabsf(v[i].z), fabsf(v[i].w)));
    for (int o = 1; o < hd / 4; o <<= 1) a = fmaxf(a, __shfl_xor_sync(fsem::kFullMask, a, o));
    const float s = quant_scale(a), r = __frcp_rn(s);
    const int c = 4 * (lane + 32 * i), h = c / hd;
    if (c < d) {
      const size_t rh = (size_t)row * lay.heads + h;
      const uint32_t w = (uint32_t)(uint8_t)quantize(v[i].x, s, r) | (uint32_t)(uint8_t)quantize(v[i].y, s, r) << 8 |
                         (uint32_t)(uint8_t)quantize(v[i].z, s, r) << 16 |
                         (uint32_t)(uint8_t)quantize(v[i].w, s, r) << 24;
      *reinterpret_cast<uint32_t*>(qk_q + part * lay.q_part() + (rh * lay.t_len + t) * hd + c % hd) = w;
      if (c % hd == 0) s_qk[part * lay.s_part() + rh * lay.t_pad + t] = s;
    }
  }
}

// -- v: per-column scales over the keys of each row, then v transposed -----------

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

// the stored position of key r (0 .. 31) inside its group of 32 keys: key
// 16 h + 2 c + i % 2 + 8 (i / 2) at 16 h + 4 c + i (h, i < 2 .. 4, c < 4),
// the k order of the m16n8k32 A fragment of P, whose thread holds the S
// accumulator's columns 2 c, 2 c + 1 of each 8; each half of 16 keys stays
// in its half, so rows padded to 16 keys hold every real key
__host__ __device__ constexpr int vt_pos(int r) {
  return (r / 16) * 16 + 4 * ((r % 8) / 2) + (r % 2) + 2 * ((r % 16) / 8);
}

// block per (32 keys, 32 columns of v, row): vt[row][head][c][t16] int8,
// the keys of each 32 in vt_pos order, zeros for keys in [T, T16)
__global__ void __launch_bounds__(256) vt_quant_kernel(const float* __restrict__ qkv, const float* __restrict__ s_v,
                                                       i8* __restrict__ vt, int t_len, int t16, int d, int heads) {
  __shared__ __align__(16) i8 tile[32][36];  // [column][stored key], rows of 36 bytes
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32, row = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float s = s_v[(size_t)row * d + c0 + tx], r = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kl = ty + 8 * i, key = k0 + kl;
    tile[tx][vt_pos(kl)] =
        key < t_len ? quantize(qkv[((size_t)row * t_len + key) * 3 * d + 2 * d + c0 + tx], s, r) : 0;
  }
  __syncthreads();
  const int cl = threadIdx.x / 8, p4 = 4 * (threadIdx.x % 8), col = c0 + cl, hd = d / heads;
  if (k0 + p4 < t16) {  // t16 % 16 == 0: a 4-byte chunk is wholly in or out
    const size_t at = (((size_t)row * heads + col / hd) * hd + col % hd) * t16 + k0 + p4;
    *reinterpret_cast<uint32_t*>(vt + at) = *reinterpret_cast<const uint32_t*>(&tile[cl][p4]);
  }
}

// -- int8 attention on TMA and wgmma ---------------------------------------------

namespace i8attn {

using namespace sm90;

enum Softmax { kExp2 = 0, kExp2Bf16 = 1, kExact = 2 };
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
constexpr int kBlockQ = 128, kBlockK = 128;
constexpr int kConsumers = 2;                        // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;     // and one producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

struct Layout {
  static constexpr int kStages = 4;
  static constexpr int kQ = kBlockQ * kRowBytes;  // Q: 128 rows of 128 bytes (a head of up to 128), 16 KB
  static constexpr int kK = kBlockK * kRowBytes;  // K of one stage: 16 KB
  static constexpr int kV = 128 * kRowBytes;      // V^T of one stage: up to 128 rows of 128 keys
  static constexpr int kStage = kK + kV;
  static constexpr int kBarOff = kQ + kStages * kStage;
  static constexpr int kBars = 1 + 2 * kStages;  // Q, full[s], empty[s]
  static constexpr size_t kBytes = kBarOff + 8 * kBars + 1024;  // + slack to align the base to 1024
  static_assert(kBytes <= 232448, "shared memory");
};

template <int kMode>
__device__ __forceinline__ float probability(float s, float row_max) {
  if constexpr (kMode == kExact) {
    return expf(s - row_max);
  } else {
    const float cl = fminf(fmaxf(s, -100.f), 60.f);
    if constexpr (kMode == kExp2Bf16) {
      return bf16_round(expf(bf16_round(bf16_round(cl) * kLn2Bf16)));
    } else {
      return exp2f(cl);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block of queries blockIdx.x * 128 .. + 128 of head blockIdx.y of row
// blockIdx.z. HDP: the head width rounded up to 32 (the k32 steps of S,
// the width of P V). s_q, s_k: (rows, heads, t_pad) scales; s_v: (rows,
// d); ctx: (rows t_len, d) fp32. Accumulator layout as flash_sm90.cuh's:
// register 4 j + e of S (or O) holds row 16 w + g + 8 (e / 2) and key (or
// column) 8 j + 2 c + e % 2.
template <int HDP, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    i8_attention_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ s_q,
                        const float* __restrict__ s_k, const float* __restrict__ s_v, float* __restrict__ ctx,
                        int t_len, int d, int heads, int t_pad) {
  using L = Layout;
  constexpr int kStages = L::kStages;
  constexpr int kWalks = kMode == kExact ? 3 : 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto k_tile = [&](int s) { return base + L::kQ + (uint32_t)s * L::kStage; };

  const int tid = threadIdx.x, warp = tid / 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q_tile = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const int n_tiles = (t_len + kBlockK - 1) / kBlockK;
  const int n_items = kWalks * n_tiles;  // V only in the last walk

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, L::kQ);
      tma_load_4d(base, &tm_q, bar_q, 0, q_tile * kBlockQ, head, row);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        const bool with_v = i >= (kWalks - 1) * n_tiles;
        const int key0 = (i % n_tiles) * kBlockK;
        mbar_expect_tx(full(s), with_v ? L::kK + HDP * kRowBytes : L::kK);
        tma_load_4d(k_tile(s), &tm_k, full(s), 0, key0, head, row);
        if (with_v) tma_load_4d(k_tile(s) + L::kK, &tm_v, full(s), key0, 0, head, row);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows wg * 64 .. + 64 of the block
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const uint32_t q_rows = base + wg * 64 * kRowBytes;
  const float kNegInf = -__int_as_float(0x7f800000);
  const size_t rh = ((size_t)row * heads + head) * t_pad;
  const int q0 = q_tile * kBlockQ + wg * 64 + (warp % 4) * 16 + g;  // this thread's rows q0 and q0 + 8
  const float sq[2] = {s_q[rh + q0], s_q[rh + q0 + 8]};                // t_pad covers the block's rows

  int o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0;
  float m[2] = {kMode == kExact ? kNegInf : 0.f, kMode == kExact ? kNegInf : 0.f};  // kExact: the row max
  float l[2] = {0.f, 0.f};  // the row sum: this thread's part, then (after the l walk) the row's
  float l_inv[2];           // __frcp_rn(l) for fsem::div_rn
  int s_acc[64];

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % kStages, walk = i / n_tiles, tile = i % n_tiles;
    // the k scales of this thread's keys tile * 128 + 8 j + 2 c (+ 1)
    float2 sk[16];
    const float* skp = s_k + rh + tile * kBlockK + 2 * cq;
#pragma unroll
    for (int j = 0; j < 16; ++j) sk[j] = *reinterpret_cast<const float2*>(skp + 8 * j);
    mbar_wait(full(s), (i / kStages) & 1);

    // S = Q K^T over HDP / 32 k-steps of 32 bytes inside a 128-byte row
    reg_fence(s_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 32; ++kk)
      wgmma_s8_ss_n128(s_acc, desc_sw128(q_rows + kk * 32, 16), desc_sw128(k_tile(s) + kk * 32, 16), kk > 0);
    wg_commit();
    wg_wait();
    reg_fence(s_acc);

    // keys past t_len (in the last tile) count as p = 0. Each value is
    // computed whole and then selected: a conditional computation would
    // branch per element and keep the compiler from interleaving a row's
    // exponentials (the softmax ran ~3x slower so)
    const int key0 = tile * kBlockK + 2 * cq;
    auto keep = [&](int e, float v, float masked) { return key0 + 8 * (e / 4) + e % 2 < t_len ? v : masked; };
    auto logit = [&](int e) {
      return __fmul_rn(__fmul_rn(__int2float_rn(s_acc[e]), sq[(e / 2) % 2]), e % 2 ? sk[e / 4].y : sk[e / 4].x);
    };

    if (walk < kWalks - 1) {  // S alone: release the stage now
      mbar_arrive(empty(s));
      if (kMode == kExact && walk == 0) {
#pragma unroll
        for (int e = 0; e < 64; ++e) m[(e / 2) % 2] = fmaxf(m[(e / 2) % 2], keep(e, logit(e), kNegInf));
        if (tile == n_tiles - 1) {
          m[0] = quad_max(m[0]);
          m[1] = quad_max(m[1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float p = probability<kMode>(logit(e), m[(e / 2) % 2]);
          l[(e / 2) % 2] += keep(e, p, 0.f);
        }
        if (tile == n_tiles - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = quad_sum(l[r]);
            l_inv[r] = __frcp_rn(l[r]);
          }
        }
      }
      continue;
    }

    // the last walk: pq = round(127 p / l) as the int8 A fragments of P V,
    // four k-steps of 32 keys (registers 16 kk .. 16 kk + 15 of S)
    auto pq = [&](int e) {  // a word whose low byte is pq
      const int r = (e / 2) % 2;
      const float x = __fmul_rn(fsem::div_rn(probability<kMode>(logit(e), m[r]), l[r], l_inv[r]), 127.f);
      return (uint32_t)__float2int_rn(keep(e, x, 0.f));
    };
    uint32_t p_frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // f: row g + 8 (f % 2), keys 16 (f / 2) + vt_pos order
        const int e0 = 4 * (4 * kk + 2 * (f / 2)) + 2 * (f % 2);
        const uint32_t lo = __byte_perm(pq(e0), pq(e0 + 1), 0x0040), hi = __byte_perm(pq(e0 + 4), pq(e0 + 5), 0x0040);
        p_frag[kk][f] = __byte_perm(lo, hi, 0x5410);  // the four low bytes
      }
    }
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_s8_rs<HDP>(o, p_frag[kk], desc_sw128(k_tile(s) + L::kK + kk * 32, 16));
    wg_commit();
    wg_wait();
    reg_fence(o);
    mbar_arrive(empty(s));
  }

  // ctx = (acc / 127) sv in fp32, the division as a product with kInv127
  const int hd = d / heads;
  const float* svp = s_v + (size_t)row * d + head * hd;
  float* out = ctx + (size_t)row * t_len * d + head * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int ee = 0; ee < 2; ++ee) {
      const int col = 8 * j + 2 * cq + ee;
      if (col >= hd) continue;
      const float sv = svp[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 8 * r;
        if (q < t_len)
          out[(size_t)q * d + col] = __fmul_rn(__fmul_rn(__int2float_rn(o[4 * j + 2 * r + ee]), kInv127), sv);
      }
    }
  }
}

template <int HDP, int kMode>
cudaError_t launch(const CUtensorMap* maps, const float* s_qk, size_t s_part, const float* s_v, float* ctx, int rows,
                   int t_len, int d, int heads, int t_pad, cudaStream_t stream) {
  constexpr size_t smem = Layout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(i8_attention_kernel<HDP, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads, rows);
  i8_attention_kernel<HDP, kMode><<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], s_qk, s_qk + s_part,
                                                                    s_v, ctx, t_len, d, heads, t_pad);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_width(const CUtensorMap* maps, const float* s_qk, size_t s_part, const float* s_v, float* ctx,
                         int rows, int t_len, int d, int heads, int t_pad, cudaStream_t stream) {
  switch ((d / heads + 31) / 32) {
    case 1: return launch<32, kMode>(maps, s_qk, s_part, s_v, ctx, rows, t_len, d, heads, t_pad, stream);
    case 2: return launch<64, kMode>(maps, s_qk, s_part, s_v, ctx, rows, t_len, d, heads, t_pad, stream);
    case 3: return launch<96, kMode>(maps, s_qk, s_part, s_v, ctx, rows, t_len, d, heads, t_pad, stream);
    case 4: return launch<128, kMode>(maps, s_qk, s_part, s_v, ctx, rows, t_len, d, heads, t_pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q, k: the two parts of qk_q, 4-D maps (hp, T, heads, rows); v: vt, a 4-D
// map (t16, hd, heads, rows) with boxes of 128 keys x HDP rows
cudaError_t attention(const i8* qk_q, const float* s_qk, const i8* vt, const float* s_v, float* ctx,
                      const QkLayout& lay, int t16, int mode, cudaStream_t stream) {
  const int hdp = (lay.hd + 31) / 32 * 32;
  CUtensorMap maps[3];
  const cuuint64_t qk_dims[4] = {(cuuint64_t)lay.hp, (cuuint64_t)lay.t_len, (cuuint64_t)lay.heads,
                                 (cuuint64_t)lay.rows};
  const cuuint64_t qk_strides[3] = {(cuuint64_t)lay.hp, (cuuint64_t)lay.t_len * lay.hp,
                                    (cuuint64_t)lay.heads * lay.t_len * lay.hp};
  const cuuint64_t v_dims[4] = {(cuuint64_t)t16, (cuuint64_t)lay.hd, (cuuint64_t)lay.heads, (cuuint64_t)lay.rows};
  const cuuint64_t v_strides[3] = {(cuuint64_t)t16, (cuuint64_t)lay.hd * t16, (cuuint64_t)lay.heads * lay.hd * t16};
  if (!tensor_map(&maps[0], qk_q, 4, qk_dims, qk_strides, kBlockQ, 1) ||
      !tensor_map(&maps[1], qk_q + lay.q_part(), 4, qk_dims, qk_strides, kBlockK, 1) ||
      !tensor_map(&maps[2], vt, 4, v_dims, v_strides, hdp, 1))
    return cudaErrorInvalidValue;
  const int d = lay.heads * lay.hd;
  switch (mode) {
    case kExp2:
      return launch_width<kExp2>(maps, s_qk, lay.s_part(), s_v, ctx, lay.rows, lay.t_len, d, lay.heads, lay.t_pad,
                                 stream);
    case kExp2Bf16:
      return launch_width<kExp2Bf16>(maps, s_qk, lay.s_part(), s_v, ctx, lay.rows, lay.t_len, d, lay.heads,
                                     lay.t_pad, stream);
    case kExact:
      return launch_width<kExact>(maps, s_qk, lay.s_part(), s_v, ctx, lay.rows, lay.t_len, d, lay.heads, lay.t_pad,
                                  stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace i8attn

// -- the block ------------------------------------------------------------------------

struct I8Block {
  const void* x;
  const i8 *wq_t, *wo_t;
  const float *bq2, *bo2, *lns, *lnb;  // bq2 = [bqkv; column scales], bo2 likewise
  i8 *row_q, *qk_q, *vt;
  float *s_row, *qkv, *s_qk, *s_v, *ctx, *y;
  void* out;
  int rows, t_len, d, heads, mode;
  float eps;
};

template <typename TX>
cudaError_t attn_block_int8(const I8Block& b, cudaStream_t stream) {
  const int M = b.rows * b.t_len, d = b.d, hd = d / b.heads;
  const int t16 = (b.t_len + 15) / 16 * 16;
  const QkLayout lay{b.rows, b.t_len, b.heads, hd, (hd + 15) / 16 * 16, (b.t_len + 127) / 128 * 128};
  const TX* x = static_cast<const TX*>(b.x);
  cudaError_t err = quant_rows<TX, true>(x, d, b.row_q, b.s_row, M, stream);
  if (err != cudaSuccess) return err;
  err = gemm90::gemm_i8(b.row_q, b.wq_t, b.s_row, b.bq2 + 3 * d, b.bq2, b.qkv, M, 3 * d, d, stream);
  if (err != cudaSuccess) return err;
  if (hd >= 16 && hd <= 128 && (hd & (hd - 1)) == 0 && d <= 128 * kQkVec)
    qk_quant_vec_kernel<<<(2 * M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, stream>>>(b.qkv, lay, b.qk_q,
                                                                                           b.s_qk);
  else
    qk_quant_kernel<<<(2 * M * b.heads + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, stream>>>(b.qkv, lay,
                                                                                                b.qk_q, b.s_qk);
  v_scale_kernel<<<dim3((d + 255) / 256, b.rows), 256, 0, stream>>>(b.qkv, b.bq2 + 2 * d, b.s_v, b.t_len, d);
  vt_quant_kernel<<<dim3(t16 / 32 + (t16 % 32 != 0), d / 32, b.rows), 256, 0, stream>>>(b.qkv, b.s_v, b.vt,
                                                                                       b.t_len, t16, d, b.heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = i8attn::attention(b.qk_q, b.s_qk, b.vt, b.s_v, b.ctx, lay, t16, b.mode, stream);
  if (err != cudaSuccess) return err;
  err = quant_rows<float, false>(b.ctx, d, b.row_q, b.s_row, M, stream);
  if (err != cudaSuccess) return err;
  err = gemm90::gemm_i8(b.row_q, b.wo_t, b.s_row, b.bo2 + d, b.bo2, b.y, M, d, d, stream);
  if (err != cudaSuccess) return err;
  return tiles::residual_ln<TX>(b.y, x, b.lns, b.lnb, static_cast<TX*>(b.out), M, d, b.eps, stream);
}

}  // namespace

// A12. x, out: (rows, t_len, d), both fp32 or both bf16 (x_bf16); wq_t:
// (3 d, d) int8, the folded [q | k | v] weights quantized per column and
// transposed; bq2: (2, 3 d) fp32, the bias and the column scales; wo_t:
// (d, d) int8 likewise, bo2 (2, d); lns, lnb: (d,) fp32. Scratch: row_q
// (rows t_len, d) int8, s_row (rows t_len,), qkv (rows t_len, 3 d) fp32,
// qk_q (2, rows, heads, t_len, hd16) int8, s_qk (2, rows, heads, t128)
// fp32 zeros, s_v (rows, d), vt (rows, heads, hd, t16) int8, ctx and y
// (rows t_len, d) fp32 (hd16, t16, t128: hd and t_len rounded up to 16,
// 16 and 128). d % 32 == 0, d / heads <= 128; mode 0 exp2, 1 exp2_bf16,
// 2 exact.
extern "C" int fsem_attn_block_int8(const void* x, const void* wq_t, const float* bq2, const void* wo_t,
                                    const float* bo2, const float* lns, const float* lnb, void* row_q, float* s_row,
                                    float* qkv, void* qk_q, float* s_qk, float* s_v, void* vt, float* ctx, float* y,
                                    void* out, int rows, int t_len, int d, int heads, int mode, int x_bf16, float eps,
                                    void* stream_ptr) {
  if (rows <= 0 || t_len <= 0 || heads <= 0 || d % heads || d / heads > 128 || d % 32 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  I8Block b{x, static_cast<const i8*>(wq_t), static_cast<const i8*>(wo_t), bq2, bo2, lns, lnb,
            static_cast<i8*>(row_q), static_cast<i8*>(qk_q), static_cast<i8*>(vt), s_row, qkv, s_qk, s_v, ctx, y,
            out, rows, t_len, d, heads, mode, eps};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(x_bf16 ? attn_block_int8<bf16>(b, stream) : attn_block_int8<float>(b, stream));
}

// A12's products alone: c (M, N) fp32 = ((a bt^T)_s32 sa[m]) sb[n] + bias[n],
// a (M, K) and bt (N, K) int8 row-major, sa (M,), sb and bias (N,) fp32.
// K % 16 == 0, N % 8 == 0.
extern "C" int fsem_gemm_i8(const void* a, const void* bt, const float* sa, const float* sb, const float* bias,
                            float* c, int M, int N, int K, void* stream_ptr) {
  return (int)gemm90::gemm_i8(static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt), sa, sb, bias, c, M, N,
                              K, static_cast<cudaStream_t>(stream_ptr));
}
