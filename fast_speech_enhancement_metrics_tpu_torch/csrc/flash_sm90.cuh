// Non-causal attention over (rows, heads, T, D) bf16 views on Hopper: kernels
// A9 (sdpa.cu, softmax exp2 / exp2_bf16 / exact), A15 (the same entry,
// softmax online) and A7's attention (attn_block.cu, modes 0-2; A11 chains
// A7); and, with WavLM's gated relative-position bias added to the logits
// in registers (RelPos below), relpos_attn_kernel (relpos_attn.cu, modes
// 0-2). Both kernels run one body, flash_body; the bias is a compile-time
// branch, so flash_kernel's instantiations hold none of it. TMA brings the
// tiles, wgmma multiplies, the softmax stays in registers.
//
// Block: 128 queries of one (row, head), 384 threads. Two consumer
// warpgroups own 64 query rows each; one thread of a producer warpgroup
// keeps TMA loads of K and V tiles in flight in a ring of kStages stages
// (full / empty mbarriers), after loading Q once. The producer warpgroup
// drops to 24 registers a thread (setmaxnreg) so that the consumers can hold
// S, P and O in 240. Per key tile of 128 (kBlockK):
//   S = Q K^T      wgmma m64n128k16, Q and K from shared memory, S in
//                  64 fp32 registers a thread;
//   softmax        per element in registers (below); the row max (kExact's
//                  first pass, kOnline's running max) is reduced over the
//                  four threads that share a row with two shuffles;
//   O += P V       P rounded to bf16 in registers is the A operand of a
//                  second wgmma (m64nHDk16), V the shared-memory B operand
//                  read transposed (MN-major); O stays in registers.
// Nothing of S, P or O goes through shared memory.
//
// Per-element softmax (softmax_p, which the float32 arm, flash_f32_sm90.cuh,
// shares):
// * kExp2: p = 2^clamp(s, -100, 60) (scale and log2 e are in q already);
// * kExp2Bf16: p = bf16(exp(bf16(bf16(clamp(s)) * bf16(ln 2))));
// * kExact: a first pass over the key tiles (S only) for the row max, then
//   p = exp(s - max), so p is rounded against the true max as on the TPU;
// * kOnline (the upstream flash kernel): s *= scale; per 128-key tile the
//   running max m, p = exp(s - m_next), l = l exp(m - m_next) + sum p. The
//   accumulator is kept unnormalised (O = O exp(m - m_next) + bf16(p) V)
//   and divided by l once at the end: the upstream kernel's per-tile
//   normalisation, up to float32 rounding.
// Keys at or past t_len give p = 0; the exp2 modes' padded keys arrive as
// l_pad, added to l at the end. A key tile wholly past t_len would leave m,
// l and O unchanged, so it is skipped: A15's keys padded to 512 cost
// nothing. Output: O / (l + l_pad) (kOnline: O / l) in bf16; query rows at
// or past t_len are not stored.
//
// Layout. q, k, v are read through 4-D TMA tensor maps (D, T, heads, rows)
// with any strides between frames, heads and rows, so one instantiation
// serves A9 / A15's contiguous (B, H, T, D) tensors and A7's (rows T, 3 d)
// qkv projection read in place (q, k and v are its three column blocks).
// Boxes of 64 columns x 128 rows and the 128-byte swizzle: one box row is
// 128 bytes, the canonical K-major tile of wgmma for Q and K and the
// MN-major one for V. Rows past T come back zero-filled, so a ragged tail
// needs no masking of the loads. Head widths: hd <= 64 takes one 64-column
// box per tile (NC = 1), 64 < hd <= 128 two (NC = 2); TMA zero-fills the
// columns past hd (D is the map's first dimension, so a box that runs over
// the head into the next one reads zeros). So heads of 64 (the main width)
// and 128 waste nothing, heads of 32 do the work of 64 and heads of 80 the
// work of 128 (1.6x). hd must be a multiple of 8 (strides of 16-byte
// multiples, a TMA rule); the callers zero-pad other widths first. The
// output goes to its own strided (rows, heads, T, D) view.
//
// Shared memory: Q (NC x 16 KB) and kStages stages of K and V (NC x 32 KB
// each): 112 KB at NC = 1 (3 stages), 160 KB at NC = 2 (2 stages); one
// block per SM. What bounds it on this card: operations, 4 T^2 D per (row,
// head) on the bf16 tensor cores, and beside them one exponential per
// logit on the SFU (16 a clock per SM, as many clocks per tile as the two
// products take at D = 64).
#pragma once

#include "sm90.cuh"

namespace {
namespace flash90 {

using namespace sm90;

enum Softmax { kExp2 = 0, kExp2Bf16 = 1, kExact = 2, kOnline = 3 };
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
constexpr int kBlockQ = 128, kBlockK = 128;
constexpr int kConsumers = 2;                        // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;     // and one producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // after setmaxnreg
constexpr int kMaxHead = 128;

template <int NC>
struct Layout {
  static constexpr int kStages = NC == 1 ? 3 : 2;
  static constexpr int kBox = kBlockK * kRowBytes;   // one 64-column box of a tile: 16 KB
  static constexpr int kQ = NC * kBox;               // Q: NC boxes of 128 rows
  static constexpr int kKV = NC * kBox;              // K (or V) of one stage
  static constexpr int kKOff = kQ;                   // stage s: K at kKOff + 2 s kKV, V after it
  static constexpr int kBarOff = kQ + kStages * 2 * kKV;
  static constexpr int kBars = 1 + 2 * kStages;      // Q, full[s], empty[s]
  static constexpr size_t kBytes = kBarOff + 8 * kBars + 1024;  // + slack to align the base to 1024
  static_assert(kBlockQ == kBlockK, "one box shape serves Q, K and V");
  static_assert(kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p of one logit (kExp2, kExp2Bf16; kExact with m = the row max; kOnline
// with s already scaled and m = m_next)
template <int kMode>
__device__ __forceinline__ float softmax_p(float s, float m) {
  if constexpr (kMode == kExp2 || kMode == kExp2Bf16) {
    const float cl = fminf(fmaxf(s, -100.f), 60.f);
    if constexpr (kMode == kExp2Bf16) return bf16_round(expf(bf16_round(bf16_round(cl) * kLn2Bf16)));
    return exp2f(cl);
  } else {
    return expf(s - m);
  }
}

// exp2 of a normal float whose result is normal: after the exp2 mode's clamp
// to [-100, 60] it is exp2f's instruction without exp2f's subnormal handling,
// the same bits (the relative-position kernel's exponential)
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// %ctaid.y / %ctaid.z read where used, so that no register holds them
// through the consumers' tile loop (held from the kernel's start, the
// exact mode ran ~2 % slower: tools/time_attention.py --against)
__device__ __forceinline__ int ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int ctaid_z() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(v));
  return v;
}

// WavLM's gated relative-position bias (relpos_attn_kernel, relpos_attn.cu):
// s[i, j] += g_i B_h(j - i) before the softmax. Per (row, frame) two bf16
// gate logits of each head at gate + row * g_row + frame * g_ld + 2 h (the
// QKV product's extra columns), g = a (b c_h - 1) + 2 of their sigmoids
// (a, b), c_h = gate_const[h]; B_h(o) = offsets[h * 2 tp + tp + o] for
// |o| < tp, tp >= t_len rounded up to kBlockK, so the padded keys and
// queries of the last tiles read inside the vector (their p and rows are
// dropped as without the bias). The vector carries the mode's log2 e.
struct RelPos {
  const bf16* gate;
  long long g_ld, g_row;
  const float* gate_const;
  const float* offsets;
  int tp;
};

// Accumulator layout of m64nNk16 (thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, c = t % 4): register i = 4 j + e (e = 0..3) holds row
// 16 w + g + 8 (e / 2) and column 8 j + 2 c + e % 2. So a thread holds two
// rows, r = (i / 2) % 2, and the registers 8 kk .. 8 kk + 7 of S are, in
// pairs, the four registers of the A fragment of keys 16 kk .. 16 kk + 15.
// With the bias (kRel), register 4 j + e takes key - query offset o0 + 8 (j
// - r) + e % 2 (o0 = the tile's first key + 2 c - the thread's first row):
// 17 x 2 offsets a thread and tile, loaded while S is multiplied. Besides,
// a consumer warpgroup whose 64 rows all lie past t_len only keeps the ring
// turning (T = 799: the last query tile's second warpgroup), and the exp2
// mode's exponential is ex2_ftz (the same bits, without exp2f's subnormal path).
template <int NC, int kMode, bool kRel>
__device__ __forceinline__ void flash_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                           bf16* __restrict__ out, int o_ld, long long o_head_stride,
                                           long long o_row_stride, int t_len, int hd, float scale, float l_pad,
                                           const RelPos& rel) {
  using L = Layout<NC>;
  constexpr int kStages = L::kStages;
  constexpr int kHalf = NC * 32;  // O registers a thread: 64 rows x 64 NC columns / 128
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto k_tile = [&](int s) { return base + L::kKOff + (uint32_t)s * 2u * L::kKV; };

  const int tid = threadIdx.x, warp = tid / 32;
  // the warpgroup, broadcast so that the compiler sees a uniform role split
  // (setmaxnreg takes effect only on warpgroup-uniform paths)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q_tile = blockIdx.x;
  const int n_tiles = (t_len + kBlockK - 1) / kBlockK;  // tiles wholly past t_len are skipped
  const int n_items = kMode == kExact ? 2 * n_tiles : n_tiles;  // kExact: K alone first

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
      const int head = ctaid_y(), row = ctaid_z();
      mbar_expect_tx(bar_q, L::kQ);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(base + c * L::kBox, &tm_q, bar_q, c * kBoxCols, q_tile * kBlockQ, head, row);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        const bool with_v = kMode != kExact || i >= n_tiles;
        const int k_row = (i >= n_tiles ? i - n_tiles : i) * kBlockK;
        mbar_expect_tx(full(s), with_v ? 2 * L::kKV : L::kKV);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(k_tile(s) + c * L::kBox, &tm_k, full(s), c * kBoxCols, k_row, head, row);
        if (with_v) {
          for (int c = 0; c < NC; ++c)
            tma_load_4d(k_tile(s) + L::kKV + c * L::kBox, &tm_v, full(s), c * kBoxCols, k_row, head, row);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows wg * 64 .. + 64 of the block
  setmaxnreg_inc<kConsumerRegs>();
  if constexpr (kRel) {
    if (q_tile * kBlockQ + wg * 64 >= t_len) {  // no query of this warpgroup is real: keep the ring turning
      for (int i = 0; i < n_items; ++i) {
        mbar_wait(full(i % kStages), (i / kStages) & 1);
        mbar_arrive(empty(i % kStages));
      }
      return;
    }
  }
  const int lane = tid % 32;
  const int g = lane / 4, cq = lane % 4;
  const uint32_t q_rows = base + wg * 64 * kRowBytes;
  const float kNegInf = -__int_as_float(0x7f800000);

  float o[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // kExact: the row max of pass 1; kOnline: the running max
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float s_acc[64];
  uint32_t p_frag[8][4];

  [[maybe_unused]] float gate[2] = {0.f, 0.f};
  [[maybe_unused]] const float* bias_at = nullptr;
  if constexpr (kRel) {
    const int head = ctaid_y(), row = ctaid_z();
    const int q_first = q_tile * kBlockQ + wg * 64 + (warp % 4) * 16 + g;
    const float c_h = rel.gate_const[head];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q_first + 8 * r;
      if (q < t_len) {
        const bf16* gl = rel.gate + row * rel.g_row + q * rel.g_ld + 2 * head;
        const float a = 1.f / (1.f + expf(-__bfloat162float(gl[0])));
        const float b = 1.f / (1.f + expf(-__bfloat162float(gl[1])));
        gate[r] = a * (b * c_h - 1.f) + 2.f;
      }
    }
    bias_at = rel.offsets + (long long)head * 2 * rel.tp + rel.tp + 2 * cq - q_first;
  }

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % kStages;
    const bool max_pass = kMode == kExact && i < n_tiles;
    const int tile = i >= n_tiles ? i - n_tiles : i;
    mbar_wait(full(s), (i / kStages) & 1);

    // S = Q K^T over NC x 4 k-steps of 16 columns (32 bytes inside a 128-byte row)
    reg_fence(s_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {
      const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
      wgmma_ss_n128(s_acc, desc_sw128(q_rows + off, 16), desc_sw128(k_tile(s) + off, 16), kk > 0);
    }
    wg_commit();
    [[maybe_unused]] float bv[kRel ? 34 : 1];  // kRel: B at offsets o0 + 8 m + b, m = -1 .. 15, b = 0, 1
    if constexpr (kRel) {
      const float* bt = bias_at + tile * kBlockK;
#pragma unroll
      for (int m = 0; m < 17; ++m) {
        bv[2 * m] = __ldg(bt + 8 * (m - 1));
        bv[2 * m + 1] = __ldg(bt + 8 * (m - 1) + 1);
      }
    }
    wg_wait();
    reg_fence(s_acc);
    if constexpr (kRel) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e / 2) % 2;
        s_acc[e] = fmaf(gate[r], bv[2 * (e / 4 - r + 1) + e % 2], s_acc[e]);
      }
    }

    // keys of this thread: tile * 128 + 8 (e / 4) + 2 c + e % 2; only the last tile is ragged
    const int key0 = tile * kBlockK + 2 * cq;
    const bool ragged = (tile + 1) * kBlockK > t_len;
    auto valid = [&](int e) { return key0 + 8 * (e / 4) + e % 2 < t_len; };
    if (max_pass) {
      mbar_arrive(empty(s));
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        if (!ragged || valid(e)) m[(e / 2) % 2] = fmaxf(m[(e / 2) % 2], s_acc[e]);
      }
      if (i == n_tiles - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
      continue;
    }

    float corr[2] = {1.f, 1.f};
    if constexpr (kMode == kOnline) {
#pragma unroll
      for (int e = 0; e < 64; ++e) s_acc[e] *= scale;
    }
    if constexpr (kMode == kExact || kMode == kOnline) {  // masked keys: exp(-inf - m) = 0
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 64; ++e) s_acc[e] = valid(e) ? s_acc[e] : kNegInf;
      }
    }
    if constexpr (kMode == kOnline) {
      float mc[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 64; ++e) mc[(e / 2) % 2] = fmaxf(mc[(e / 2) % 2], s_acc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_next = fmaxf(m[r], quad_max(mc[r]));  // finite: the tile has a valid key
        corr[r] = expf(m[r] - m_next);
        m[r] = m_next;
      }
    }
    // P in place of S
    if constexpr (kRel && kMode == kExp2) {
#pragma unroll
      for (int e = 0; e < 64; ++e) s_acc[e] = ex2_ftz(fminf(fmaxf(s_acc[e], -100.f), 60.f));
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) s_acc[e] = softmax_p<kMode>(s_acc[e], m[(e / 2) % 2]);
    }
    if constexpr (kMode == kExp2 || kMode == kExp2Bf16) {  // masked keys: 0, not the clamp's 2^-100
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 64; ++e) s_acc[e] = valid(e) ? s_acc[e] : 0.f;
      }
    }
    float lt[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      lt[(e / 2) % 2] += s_acc[e] + s_acc[e + 1];
      p_frag[e / 8][(e / 2) % 4] = pack_bf16(s_acc[e], s_acc[e + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = kMode == kOnline ? l[r] * corr[r] + lt[r] : l[r] + lt[r];
    if constexpr (kMode == kOnline) {
#pragma unroll
      for (int e = 0; e < kHalf; ++e) o[e] *= corr[(e / 2) % 2];
    }

    // O += bf16(P) V over 8 k-steps of 16 keys (16 rows of 128 bytes of V)
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t desc_v = desc_sw128(k_tile(s) + L::kKV + kk * 16 * kRowBytes, L::kBox);
      if constexpr (NC == 1) {
        wgmma_rs_n64(o, p_frag[kk], desc_v);
      } else {
        wgmma_rs_n128(o, p_frag[kk], desc_v);
      }
    }
    wg_commit();
    wg_wait();
    reg_fence(o);
    mbar_arrive(empty(s));
  }

  // the output: O / (l + l_pad), or O / l for kOnline, in bf16
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) den[r] = quad_sum(l[r]) + (kMode == kOnline ? 0.f : l_pad);
  const int q0 = q_tile * kBlockQ + wg * 64 + (warp % 4) * 16 + g;
  bf16* out_bh = out + ctaid_z() * o_row_stride + ctaid_y() * o_head_stride;
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
    const int col = 8 * j + 2 * cq;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 8 * r;
      if (q < t_len) {
        *reinterpret_cast<uint32_t*>(out_bh + (q * o_ld + col)) =
            pack_bf16(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
      }
    }
  }
}

template <int NC, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int o_ld,
                 long long o_head_stride, long long o_row_stride, int t_len, int hd, float scale, float l_pad) {
  flash_body<NC, kMode, false>(tm_q, tm_k, tm_v, out, o_ld, o_head_stride, o_row_stride, t_len, hd, scale, l_pad,
                               RelPos{});
}

// the same with WavLM's gated relative-position bias (modes 0-2)
template <int NC, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    relpos_attn_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int o_ld,
                       long long o_head_stride, long long o_row_stride, int t_len, int hd,
                       const __grid_constant__ RelPos rel) {
  flash_body<NC, kMode, true>(tm_q, tm_k, tm_v, out, o_ld, o_head_stride, o_row_stride, t_len, hd, 1.f, 0.f, rel);
}

// -- host side ---------------------------------------------------------------
// A strided (rows, heads, T, hd) bf16 view; element strides between frames,
// heads and rows (hd is contiguous)
struct View {
  const void* ptr;
  long long ld, head_stride, row_stride;
};

// boxes of 64 columns x 128 frames of one (row, head)
inline bool view_map(CUtensorMap* map, const View& v, int rows, int heads, int t_len, int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)t_len, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {(cuuint64_t)v.ld * 2, (cuuint64_t)v.head_stride * 2, (cuuint64_t)v.row_stride * 2};
  return tensor_map(map, v.ptr, 4, dims, strides, kBlockK);
}

template <int NC, int kMode>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const View& o, int rows,
                   int heads, int t_len, int hd, float scale, float l_pad, cudaStream_t stream) {
  constexpr size_t smem = Layout<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<NC, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads, rows);
  flash_kernel<NC, kMode><<<grid, kThreads, smem, stream>>>(q, k, v, static_cast<bf16*>(const_cast<void*>(o.ptr)),
                                                            (int)o.ld, o.head_stride, o.row_stride, t_len, hd, scale,
                                                            l_pad);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_mode(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const View& o, int rows,
                        int heads, int t_len, int hd, int mode, float scale, float l_pad, cudaStream_t stream) {
  switch (mode) {
    case kExp2: return launch<NC, kExp2>(q, k, v, o, rows, heads, t_len, hd, scale, l_pad, stream);
    case kExp2Bf16: return launch<NC, kExp2Bf16>(q, k, v, o, rows, heads, t_len, hd, scale, l_pad, stream);
    case kExact: return launch<NC, kExact>(q, k, v, o, rows, heads, t_len, hd, scale, l_pad, stream);
    case kOnline: return launch<NC, kOnline>(q, k, v, o, rows, heads, t_len, hd, scale, l_pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int NC, int kMode>
cudaError_t launch_rel(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const View& o, int rows,
                       int heads, int t_len, int hd, const RelPos& rel, cudaStream_t stream) {
  constexpr size_t smem = Layout<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(relpos_attn_kernel<NC, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads, rows);
  relpos_attn_kernel<NC, kMode><<<grid, kThreads, smem, stream>>>(
      q, k, v, static_cast<bf16*>(const_cast<void*>(o.ptr)), (int)o.ld, o.head_stride, o.row_stride, t_len, hd, rel);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_rel_mode(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const View& o, int rows,
                            int heads, int t_len, int hd, int mode, const RelPos& rel, cudaStream_t stream) {
  switch (mode) {
    case kExp2: return launch_rel<NC, kExp2>(q, k, v, o, rows, heads, t_len, hd, rel, stream);
    case kExp2Bf16: return launch_rel<NC, kExp2Bf16>(q, k, v, o, rows, heads, t_len, hd, rel, stream);
    case kExact: return launch_rel<NC, kExact>(q, k, v, o, rows, heads, t_len, hd, rel, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash90
}  // namespace

// Attention over strided (rows, heads, t_len, hd) bf16 views: q, k and v
// share the element strides (ld between frames, head_stride, row_stride),
// o has its own (t_len o_ld < 2^31). hd a multiple of 8, at most 128;
// every stride a multiple of 8 elements and the pointers 16-byte aligned
// (TMA). mode 0 exp2, 1 exp2_bf16, 2 exact, 3 online. Defined in sdpa.cu, the one translation
// unit that instantiates flash_kernel; A9 / A15 (sdpa.cu) and A7
// (attn_block.cu) launch it.
int fsem_flash_attention(const void* q, const void* k, const void* v, long long ld, long long head_stride,
                         long long row_stride, void* o, long long o_ld, long long o_head_stride,
                         long long o_row_stride, int rows, int heads, int t_len, int hd, int mode, float scale,
                         float l_pad, cudaStream_t stream);
