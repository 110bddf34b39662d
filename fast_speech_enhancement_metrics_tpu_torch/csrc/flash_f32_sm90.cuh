// Non-causal attention in float32 on the bf16 tensor cores: the
// precision="highest" arm of A9 (softmax exp2 / exp2_bf16 / exact) and A15
// (online), launched by sdpa_f32.cu over (B H, T, D) tensors.
//
// The arithmetic is the TPU's own for this arm: "highest" runs the MXU in
// bf16x6 passes. Each float32 operand arrives split into three bf16 pieces,
// x = x0 + x1 + x2 (halves::split_rows<3>, sdr_halves.cuh, up front), and
// a product is the six piece products of order <= 2 (x0 y0, x0 y1, x1 y0,
// x0 y2, x1 y1, x2 y0), each exact in the tensor cores and summed in their
// float32 accumulator, small terms first: (1,1), (0,2), (2,0), (0,1),
// (1,0), then (0,0), so that the accumulator holds them before it reaches
// the main term's magnitude (added after it, wgmma's accumulator loses
// their low bits). The dropped terms are ~2^-24 of the product: float32
// class. ops/sdpa_pallas.py::_sdpa_f32_pieces_reference is the same
// dataflow in torch.
//
// Block: flash_sm90.cuh's shape. 128 queries of one (row, head), 384
// threads: one TMA thread of a producer warpgroup (24 registers after
// setmaxnreg) loads Q's three pieces once, then streams items through a
// ring of kSlots slots (full / empty mbarriers), each item the three pieces
// of K or of V of one key tile of kBlockK = 64 keys; two consumer
// warpgroups (240 registers) own 64 query rows each. Per key tile:
//   S = Q K^T   six products x NC 4 k-steps of wgmma m64n64k16, Q and K
//               from shared memory, S in 32 fp32 registers a thread;
//   softmax     per element in registers, as flash_sm90.cuh's softmax_p
//               (kExact: a first pass over the key tiles, S formed exactly
//               as in the second, for the row max; kOnline: s *= scale,
//               the running max, O and l rescaled by exp(m - m_next));
//   P pieces    p split into three bf16 register fragments in S's
//               registers' place (halves::split_pair);
//   O += P V    six products x 4 k-steps of register-A wgmma m64nHDk16
//               into a per-tile partial, V read MN-major (the transpose
//               bit), then O = O + partial (kOnline: O exp(m - m_next) +
//               partial) in float32 FMAs: each tile's 24 accumulator
//               steps round at the tile's magnitude, not at O's.
// Keys at or past t_len give p = 0; the exp2 modes' padded keys arrive as
// l_pad. Key tiles wholly past t_len are never loaded (A15's keys padded to
// 512 cost nothing). Output: O / (l + l_pad) (kOnline: O / l) in float32;
// query rows at or past t_len and columns at or past hd are not stored.
//
// Layout. The pieces are (3 tensors, 3 pieces, B H, T, D_p) bf16, D_p the
// head zero-padded to the 64-column TMA box (NC = 1: D_p = 64, hd <= 64;
// NC = 2: 128, hd <= 128), so any head width takes the aligned path. One
// 4-D tensor map (D_p, T, B H, piece) per tensor; boxes of 64 columns x 128
// rows (Q) or 64 rows (K, V) in the 128-byte swizzle, rows past T read as
// zeros.
//
// Shared memory, the first constraint: three pieces of Q, K and V at
// flash_sm90.cuh's kBlockK = 128 and D = 64 are 48 KB of Q plus 2 x 48 KB a
// stage, so two stages do not fit in 227 KB. Hence key tiles of 64 and a
// ring of single operands (K or V of a tile, 24 NC KB):
//   NC = 1: Q 48 KB + 7 slots x 24 KB = 216 KB (+ barriers, 1 KB align);
//   NC = 2: Q 96 KB + 2 slots x 48 KB = 192 KB.
// Registers, the second: a consumer thread holds O and the partial (32 NC
// each), S (32) and then P's pieces (3 x 16) in S's place: 144 at NC = 1,
// 208 at NC = 2, under setmaxnreg's 240.
//
// What bounds it on this card: operations, 6 x 4 T^2 D per (row, head) on
// the bf16 tensor cores (kExact: 6 x 6 T^2 D with its max pass), beside one
// exponential and a three-piece split per logit.
#pragma once

#include "flash_sm90.cuh"
#include "sdr_halves.cuh"

namespace {
namespace flash32 {

using namespace sm90;
// flash_sm90.cuh's block: 128 queries, two consumer warpgroups and a
// producer one, their registers after setmaxnreg, heads up to 128
using flash90::kBlockQ;
using flash90::kConsumerRegs;
using flash90::kConsumers;
using flash90::kExact;
using flash90::kMaxHead;
using flash90::kOnline;
using flash90::kProducerRegs;
using flash90::kThreads;

constexpr int kBlockK = 64;
constexpr int kPieces = 3;
constexpr int kProducts = 6;

// the pieces (of q or p, of k or v) of product t: (1,1), (0,2), (2,0),
// (0,1), (1,0), (0,0)
__host__ __device__ constexpr int piece_a(int t) { return t == 0 || t == 4 ? 1 : (t == 2 ? 2 : 0); }
__host__ __device__ constexpr int piece_b(int t) { return t == 0 || t == 3 ? 1 : (t == 1 ? 2 : 0); }

template <int NC>
struct Layout {
  static constexpr int kQBox = kBlockQ * kRowBytes;    // 64 columns x 128 query rows: 16 KB
  static constexpr int kKVBox = kBlockK * kRowBytes;   // 64 columns x 64 key rows: 8 KB
  static constexpr int kQ = kPieces * NC * kQBox;      // piece p, box c at (p NC + c) kQBox
  static constexpr int kItem = kPieces * NC * kKVBox;  // K or V of one key tile, laid out alike
  static constexpr int kSlots = NC == 1 ? 7 : 2;
  static constexpr int kBarOff = kQ + kSlots * kItem;
  static constexpr int kBars = 1 + 2 * kSlots;         // Q, full[s], empty[s]
  static constexpr size_t kBytes = kBarOff + 8 * kBars + 1024;  // + slack to align the base to 1024
  static_assert(kBytes <= 232448, "shared memory");
};

// S (64 x 64) = this warpgroup's 64 query rows times the key tile in k_slot
template <int NC>
__device__ __forceinline__ void logits(float (&s_acc)[32], uint32_t q_rows, uint32_t k_slot) {
  using L = Layout<NC>;
  reg_fence(s_acc);
  wg_fence();
#pragma unroll
  for (int t = 0; t < kProducts; ++t) {
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {  // 16 columns (32 bytes inside a 128-byte row) a step
      const uint32_t qa = q_rows + (piece_a(t) * NC + kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t kb = k_slot + (piece_b(t) * NC + kk / 4) * L::kKVBox + (kk % 4) * 32;
      wgmma_ss_n64(s_acc, desc_sw128(qa, 16), desc_sw128(kb, 16), t > 0 || kk > 0);
    }
  }
  wg_commit();
  wg_wait();
  reg_fence(s_acc);
}

// partial (64 x 64 NC) = P (its pieces' A fragments, 16 keys a step) times
// the V tile in v_slot, read MN-major
template <int NC>
__device__ __forceinline__ void context(float (&partial)[NC * 32], const uint32_t (&pa)[kPieces][4][4],
                                        uint32_t v_slot) {
  using L = Layout<NC>;
  reg_fence(partial);
  wg_fence();
#pragma unroll
  for (int t = 0; t < kProducts; ++t) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint64_t desc_v =
          desc_sw128(v_slot + piece_b(t) * NC * L::kKVBox + kk * 16 * kRowBytes, L::kKVBox);
      if constexpr (NC == 1) {
        wgmma_rs_n64(partial, pa[piece_a(t)][kk], desc_v, t > 0 || kk > 0);
      } else {
        wgmma_rs_n128(partial, pa[piece_a(t)][kk], desc_v, t > 0 || kk > 0);
      }
    }
  }
  wg_commit();
  wg_wait();
  reg_fence(partial);
}

// Accumulator layout of m64nNk16 (flash_sm90.cuh): register i = 4 j + e of
// thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j +
// 2 (t % 4) + e % 2; registers 8 kk .. 8 kk + 7 of S, in pairs, are the A
// fragment of keys 16 kk .. 16 kk + 15.
template <int NC, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, float* __restrict__ out, int t_len, int hd,
                     float scale, float l_pad) {
  using L = Layout<NC>;
  constexpr int kSlots = L::kSlots;
  constexpr int kHalf = NC * 32;  // O registers a thread: 64 rows x 64 NC columns / 128
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kSlots + s); };
  auto slot = [&](int s) { return base + L::kQ + (uint32_t)s * L::kItem; };

  const int tid = threadIdx.x, warp = tid / 32;
  // the warpgroup, broadcast so that the compiler sees a uniform role split
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q_tile = blockIdx.x;
  const int n_tiles = (t_len + kBlockK - 1) / kBlockK;  // tiles wholly past t_len are skipped
  // items: K of each tile (kExact's max pass), then K and V of each tile in turn
  const int n_items = (kMode == kExact ? 3 : 2) * n_tiles;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * 128) {
      const int bh = flash90::ctaid_z() * (int)gridDim.y + flash90::ctaid_y();
      mbar_expect_tx(bar_q, L::kQ);
      for (int p = 0; p < kPieces; ++p)
        for (int c = 0; c < NC; ++c)
          tma_load_4d(base + (p * NC + c) * L::kQBox, &tm_q, bar_q, c * kBoxCols, q_tile * kBlockQ, bh, p);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kSlots;
        if (i >= kSlots) mbar_wait(empty(s), ((i / kSlots) - 1) & 1);
        const int j = kMode == kExact ? i - n_tiles : i;
        const bool is_v = j >= 0 && (j & 1);
        const int tile = j >= 0 ? j / 2 : i;
        mbar_expect_tx(full(s), L::kItem);
        for (int p = 0; p < kPieces; ++p) {
          for (int c = 0; c < NC; ++c) {
            const uint32_t dst = slot(s) + (p * NC + c) * L::kKVBox;
            if (is_v) {
              tma_load_4d(dst, &tm_v, full(s), c * kBoxCols, tile * kBlockK, bh, p);
            } else {
              tma_load_4d(dst, &tm_k, full(s), c * kBoxCols, tile * kBlockK, bh, p);
            }
          }
        }
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

  float o[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) o[e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // kExact: the row max of pass 1; kOnline: the running max
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float s_acc[32];
  float partial[kHalf];
  uint32_t pa[kPieces][4][4];

  mbar_wait(bar_q, 0);
  int i = 0;  // the next item
  if constexpr (kMode == kExact) {
    for (int tile = 0; tile < n_tiles; ++tile, ++i) {
      const int s = i % kSlots;
      mbar_wait(full(s), (i / kSlots) & 1);
      logits<NC>(s_acc, q_rows, slot(s));
      mbar_arrive(empty(s));
      const int key0 = tile * kBlockK + 2 * cq;
      const bool ragged = (tile + 1) * kBlockK > t_len;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (!ragged || key0 + 8 * (e / 4) + e % 2 < t_len) m[(e / 2) % 2] = fmaxf(m[(e / 2) % 2], s_acc[e]);
      }
    }
    m[0] = flash90::quad_max(m[0]);
    m[1] = flash90::quad_max(m[1]);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    int s = i % kSlots;
    mbar_wait(full(s), (i / kSlots) & 1);
    logits<NC>(s_acc, q_rows, slot(s));
    mbar_arrive(empty(s));
    ++i;

    // keys of this thread: tile * 64 + 8 (e / 4) + 2 c + e % 2; only the last tile is ragged
    const int key0 = tile * kBlockK + 2 * cq;
    const bool ragged = (tile + 1) * kBlockK > t_len;
    auto valid = [&](int e) { return key0 + 8 * (e / 4) + e % 2 < t_len; };
    float corr[2] = {1.f, 1.f};
    if constexpr (kMode == kOnline) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s_acc[e] *= scale;
    }
    if constexpr (kMode == kExact || kMode == kOnline) {  // masked keys: exp(-inf - m) = 0
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s_acc[e] = valid(e) ? s_acc[e] : kNegInf;
      }
    }
    if constexpr (kMode == kOnline) {
      float mc[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) mc[(e / 2) % 2] = fmaxf(mc[(e / 2) % 2], s_acc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_next = fmaxf(m[r], flash90::quad_max(mc[r]));  // finite: the tile has a valid key
        corr[r] = expf(m[r] - m_next);
        m[r] = m_next;
      }
    }
    // P in place of S
#pragma unroll
    for (int e = 0; e < 32; ++e) s_acc[e] = flash90::softmax_p<kMode>(s_acc[e], m[(e / 2) % 2]);
    if constexpr (kMode != kExact && kMode != kOnline) {  // masked keys: 0, not the clamp's 2^-100
      if (ragged) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s_acc[e] = valid(e) ? s_acc[e] : 0.f;
      }
    }
    float lt[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      lt[(e / 2) % 2] += s_acc[e] + s_acc[e + 1];
      uint32_t w[kPieces];
      halves::split_pair<kPieces>(s_acc[e], s_acc[e + 1], w);
#pragma unroll
      for (int q = 0; q < kPieces; ++q) pa[q][e / 8][(e / 2) % 4] = w[q];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = kMode == kOnline ? l[r] * corr[r] + lt[r] : l[r] + lt[r];

    s = i % kSlots;
    mbar_wait(full(s), (i / kSlots) & 1);
    context<NC>(partial, pa, slot(s));
    mbar_arrive(empty(s));
    ++i;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      o[e] = kMode == kOnline ? fmaf(o[e], corr[(e / 2) % 2], partial[e]) : o[e] + partial[e];
    }
  }

  // the output: O / (l + l_pad), or O / l for kOnline
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) den[r] = flash90::quad_sum(l[r]) + (kMode == kOnline ? 0.f : l_pad);
  const int q0 = q_tile * kBlockQ + wg * 64 + (warp % 4) * 16 + g;
  const size_t bh = (size_t)flash90::ctaid_z() * gridDim.y + flash90::ctaid_y();
  float* out_bh = out + bh * t_len * hd;
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
    const int col = 8 * j + 2 * cq;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 8 * r;
      if (q < t_len) {
        float* dst = out_bh + (size_t)q * hd + col;
        dst[0] = o[4 * j + 2 * r] / den[r];
        if (col + 1 < hd) dst[1] = o[4 * j + 2 * r + 1] / den[r];
      }
    }
  }
}

// -- host side ---------------------------------------------------------------
template <int NC, int kMode>
cudaError_t launch(const CUtensorMap (&maps)[3], float* out, int batch, int heads, int t_len, int hd, float scale,
                   float l_pad, cudaStream_t stream) {
  constexpr size_t smem = Layout<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<NC, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_f32_kernel<NC, kMode><<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], out, t_len, hd, scale,
                                                                l_pad);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_mode(const CUtensorMap (&maps)[3], float* out, int batch, int heads, int t_len, int hd, int mode,
                        float scale, float l_pad, cudaStream_t stream) {
  switch (mode) {
    case flash90::kExp2: return launch<NC, flash90::kExp2>(maps, out, batch, heads, t_len, hd, scale, l_pad, stream);
    case flash90::kExp2Bf16:
      return launch<NC, flash90::kExp2Bf16>(maps, out, batch, heads, t_len, hd, scale, l_pad, stream);
    case kExact: return launch<NC, kExact>(maps, out, batch, heads, t_len, hd, scale, l_pad, stream);
    case kOnline: return launch<NC, kOnline>(maps, out, batch, heads, t_len, hd, scale, l_pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash32
}  // namespace
