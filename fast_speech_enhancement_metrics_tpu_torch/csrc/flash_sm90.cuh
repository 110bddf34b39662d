// Non-causal attention over (B H, T, D) bf16 tensors on Hopper: kernels A9
// (sdpa.cu, softmax exp2 / exp2_bf16 / exact) and A15 (the same entry,
// softmax online). TMA brings the tiles, wgmma multiplies, the softmax
// stays in registers.
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
// Per-element softmax (as attention_core.cuh:19-27, the wmma core of A7):
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
// Layout. q, k, v are read through 3-D TMA tensor maps (D, T, B H) with
// boxes of 64 columns x 128 rows and the 128-byte swizzle: one box row is
// 128 bytes, the canonical K-major tile of wgmma for Q and K and the
// MN-major one for V. Rows past T come back zero-filled, so a ragged tail
// needs no masking of the loads. Head widths: hd <= 64 takes one 64-column
// box per tile (NC = 1), 64 < hd <= 128 two (NC = 2); TMA zero-fills the
// columns past hd. So heads of 64 (the main width) and 128 waste nothing,
// heads of 32 do the work of 64 and heads of 80 the work of 128 (1.6x). hd
// must be a multiple of 8 (rows of 16-byte multiples, a TMA rule); the
// wrapper zero-pads other widths first.
//
// Shared memory: Q (NC x 16 KB) and kStages stages of K and V (NC x 32 KB
// each): 112 KB at NC = 1 (3 stages), 160 KB at NC = 2 (2 stages); one
// block per SM. What bounds it on this card: operations, 4 T^2 D per (row,
// head) on the bf16 tensor cores, and beside them one exponential per
// logit on the SFU (16 a clock per SM, as many clocks per tile as the two
// products take at D = 64).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace flash90 {

using bf16 = __nv_bfloat16;

enum Softmax { kExp2 = 0, kExp2Bf16 = 1, kExact = 2, kOnline = 3 };
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
constexpr int kBlockQ = 128, kBlockK = 128, kBoxCols = 64, kRowBytes = 128;
constexpr int kConsumers = 2;                        // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;     // and one producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (128 x 24 + 256 x 240 <= 65 536)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// spins until the phase of the given parity has completed; no timeout (a
// clock read kept live through the tile loop costs registers: spills and
// serialized wgmma at heads of 80 and 128)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// -- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading byte offset (MN-major: the stride between 64-column boxes), stride
// byte offset 1024 (between groups of 8 rows of 128 bytes), layout 1 (SW128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }
// keeps the compiler from moving reads or writes of r across an asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, fp32) [+]= A (64 x 16) B (16 x N). ss: A and B from shared memory,
// both K-major; rs: A from registers (the m16n8k16 A fragments of the four
// warps), B from shared memory read transposed (MN-major); rs accumulates.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// Accumulator layout of m64nNk16 (thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, c = t % 4): register i = 4 j + e (e = 0..3) holds row
// 16 w + g + 8 (e / 2) and column 8 j + 2 c + e % 2. So a thread holds two
// rows, r = (i / 2) % 2, and the registers 8 kk .. 8 kk + 7 of S are, in
// pairs, the four registers of the A fragment of keys 16 kk .. 16 kk + 15.
template <int NC, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int heads, int t_len, int hd,
                 float scale, float l_pad) {
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
  const int q_tile = blockIdx.x, bh = blockIdx.z * heads + blockIdx.y;
  const int n_tiles = (t_len + kBlockK - 1) / kBlockK;  // tiles wholly past t_len are skipped
  const int n_items = kMode == kExact ? 2 * n_tiles : n_tiles;  // kExact: K alone first

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int c = 0; c < NC; ++c) tma_load(base + c * L::kBox, &tm_q, bar_q, c * kBoxCols, q_tile * kBlockQ, bh);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        const bool with_v = kMode != kExact || i >= n_tiles;
        const int row = (i >= n_tiles ? i - n_tiles : i) * kBlockK;
        mbar_expect_tx(full(s), with_v ? 2 * L::kKV : L::kKV);
        for (int c = 0; c < NC; ++c) tma_load(k_tile(s) + c * L::kBox, &tm_k, full(s), c * kBoxCols, row, bh);
        if (with_v) {
          for (int c = 0; c < NC; ++c)
            tma_load(k_tile(s) + L::kKV + c * L::kBox, &tm_v, full(s), c * kBoxCols, row, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows wg * 64 .. + 64 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
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
    wg_wait();
    reg_fence(s_acc);

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
#pragma unroll
    for (int e = 0; e < 64; ++e) s_acc[e] = softmax_p<kMode>(s_acc[e], m[(e / 2) % 2]);
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
  bf16* out_bh = out + (size_t)bh * t_len * hd;
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
    const int col = 8 * j + 2 * cq;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 8 * r;
      if (q < t_len) {
        *reinterpret_cast<uint32_t*>(out_bh + (size_t)q * hd + col) =
            pack_bf16(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// (hd, t_len, bh) bf16, boxes of 64 columns x 128 rows, 128-byte swizzle,
// zeros outside the tensor
inline bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int t_len, int hd) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)t_len, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)t_len * hd * 2};
  const cuuint32_t box[3] = {kBoxCols, kBlockK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int kMode>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, bf16* o, int batch, int heads,
                   int t_len, int hd, float scale, float l_pad, cudaStream_t stream) {
  constexpr size_t smem = Layout<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<NC, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_kernel<NC, kMode><<<grid, kThreads, smem, stream>>>(q, k, v, o, heads, t_len, hd, scale, l_pad);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_mode(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, bf16* o, int batch,
                        int heads, int t_len, int hd, int mode, float scale, float l_pad, cudaStream_t stream) {
  switch (mode) {
    case kExp2: return launch<NC, kExp2>(q, k, v, o, batch, heads, t_len, hd, scale, l_pad, stream);
    case kExp2Bf16: return launch<NC, kExp2Bf16>(q, k, v, o, batch, heads, t_len, hd, scale, l_pad, stream);
    case kExact: return launch<NC, kExact>(q, k, v, o, batch, heads, t_len, hd, scale, l_pad, stream);
    case kOnline: return launch<NC, kOnline>(q, k, v, o, batch, heads, t_len, hd, scale, l_pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash90
}  // namespace
