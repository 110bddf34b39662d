// C = epilogue(A B + bias) on Hopper: the four products of the post-LN
// encoder blocks A7 (QKV, W_o) and A8 (W_1, W_2), attn_block.cu, and, in
// int8, the two of A12 (QKV, W_o), attn_block_int8.cu.
//
// bf16: A (M, K) row-major, B (K, N) row-major (the packed weights of
// pack_attn_block_params / pack_ffn_block_params as they are), bias (N,)
// fp32; C (M, N) row-major, bf16 or fp32 by the epilogue:
//   kBiasBf16      bf16(acc + bias)               QKV
//   kBiasGeluBf16  bf16(gelu_tanh(acc + bias))    W_1 (the GELU in fp32)
//   kBiasF32       acc + bias in fp32             W_o, W_2
// K % 8 == 0 and N % 8 == 0 (TMA's 16-byte stride rule); any M.
// int8 (kDequantF32): A (M, K) int8 row-major, B given as Bt (N, K) int8
// row-major (the (out, in) layout of the int8 packing: 8-bit wgmma takes
// both operands K-major, it has no transpose bit), the row scales sa (M,),
// column scales sb (N,) and bias (N,) fp32; C (M, N) fp32 =
// ((acc_s32 sa[m]) sb[n]) + bias[n], each step rounded (__fmul_rn,
// __fadd_rn: no FMA), the plain version's order. K % 16 == 0, N % 8 == 0.
//
// What bounds it on this card: operations, 2 M N K on the tensor cores
// (at mHuBERT-147's width and 64 rows of 799 frames, M = 51 136: QKV 0.18
// TFLOP, W_o 0.06, W_1 and W_2 0.24 each, against 0.1-0.4 GB of bytes; in
// int8 at twice the rate, QKV 0.09 ms and W_o 0.03 ms at 1979 TOP/s).
//
// Design (flash_sm90.cuh's): a persistent grid of one block per SM walks
// the 128 x 256 output tiles, N fastest, so the blocks in flight share A's
// rows in L2. A producer warpgroup drops to 24 registers (setmaxnreg) and
// one of its threads keeps TMA loads in flight in a ring of kStages stages
// (full / empty mbarriers): per k block of one 128-byte row (64 bf16 or
// 128 int8 columns), A's 128-row box (K-major, 128-byte swizzle) and B's
// 256 columns: in bf16 four boxes of 64 x 64 (N contiguous: read by wgmma
// MN-major, the descriptor's transpose bit, as flash_sm90.cuh reads V), in
// int8 one K-major box of 256 rows of Bt. Two consumer warpgroups at 240
// registers own 64 rows each and run wgmma m64n256k16 (bf16) or m64n256k32
// (int8) with the accumulator in registers, one k block's products in
// flight while the next is issued; the producer runs ahead into the next
// tile while they apply the epilogue from registers and store the tile
// through a small shared-memory scratch in whole 128-byte row chunks. The
// bf16 epilogues keep the bias of the thread's columns in registers; the
// int8 one has two per-column vectors, too many registers beside its 128
// accumulators, so each warpgroup stages sb and the bias of the tile's
// columns in shared memory. Rows past M and columns past N load as TMA's
// zeros and are not stored; K past its end adds zeros. The host functions
// that encode the tensor maps and pick an instantiation live in the
// translation unit that launches them (gemm90::gemm in attn_block.cu,
// gemm90::gemm_i8 in attn_block_int8.cu), so each builds only its own.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace {
namespace gemm90 {

using namespace sm90;

enum Epilogue { kBiasBf16 = 0, kBiasGeluBf16 = 1, kBiasF32 = 2, kDequantF32 = 3 };
constexpr int kBM = 128, kBN = 256, kBK = 64;  // kBK in bf16 columns: one 128-byte row
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // and one producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

struct Layout {
  static constexpr int kA = kBM * kRowBytes;     // A: 128 rows x 64 columns, 16 KB
  static constexpr int kBBox = kBK * kRowBytes;  // one 64-column box of B: 64 k rows, 8 KB
  static constexpr int kB = kBN / kBoxCols * kBBox;
  static constexpr int kStage = kA + kB;  // 48 KB
  static constexpr int kStages = 4;
  // the epilogue's scratch: per consumer warp 16 rows of one 128-byte chunk
  // of columns, each row padded by 16 bytes (the 8 rows of a store hit
  // distinct banks)
  static constexpr int kOutRow = kRowBytes + 16;
  static constexpr int kOutWarp = 16 * kOutRow;
  static constexpr int kOutOff = kStages * kStage;
  // int8: per consumer warpgroup the tile's column scales and bias
  static constexpr int kColOff = kOutOff + kConsumers * 4 * kOutWarp;
  static constexpr int kCols = 2 * kBN * sizeof(float);
  static constexpr int kBarOff = kColOff + kConsumers * kCols;
  static constexpr size_t kBytes = kBarOff + 8 * 2 * kStages + 1024;  // + slack to align the base to 1024
  static_assert(kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// Accumulator layout of m64nNk16 / m64nNk32 (thread t of the warpgroup,
// warp w = t / 32, g = (t % 32) / 4, c = t % 4): register 4 j + e holds row
// 16 w + g + 8 (e / 2) and column 8 j + 2 c + e % 2 of the warpgroup's 64
// rows. The epilogue writes a warp's 16 rows through shared memory one
// 128-byte chunk of columns at a time and stores each row's chunk whole:
// 16 bytes a lane, 8 lanes a row. int8: sa, sb, bias the dequantization's
// vectors; bf16: sa and sb unused.
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ sa, const float* __restrict__ sb, const float* __restrict__ bias,
                void* __restrict__ c_out, int M, int N, int K) {
  using L = Layout;
  constexpr bool kI8 = kEpi == kDequantF32;
  constexpr int kStages = L::kStages;
  constexpr int kBKElems = kI8 ? 2 * kBK : kBK;  // k columns of one 128-byte row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t bars = base + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto a_tile = [&](int s) { return base + (uint32_t)s * L::kStage; };

  const int tid = threadIdx.x;
  // the warpgroup, broadcast so that the compiler sees a uniform role split
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = n_tiles * ((M + kBM - 1) / kBM);
  const int k_blocks = (K + kBKElems - 1) / kBKElems;

  if (tid == 0) {
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
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * kBN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          mbar_expect_tx(full(s), L::kStage);
          tma_load_2d(a_tile(s), &tm_a, full(s), kb * kBKElems, m0);
          if constexpr (kI8) {
            tma_load_2d(a_tile(s) + L::kA, &tm_b, full(s), kb * kBKElems, n0);
          } else {
#pragma unroll
            for (int c = 0; c < kBN / kBoxCols; ++c)
              tma_load_2d(a_tile(s) + L::kA + c * L::kBBox, &tm_b, full(s), n0 + c * kBoxCols, kb * kBK);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 .. + 64 of each tile
  setmaxnreg_inc<kConsumerRegs>();
  using TC = std::conditional_t<kEpi == kBiasF32 || kI8, float, bf16>;
  using TAcc = std::conditional_t<kI8, int, float>;
  constexpr int kChunkCols = kRowBytes / sizeof(TC);  // 64 bf16 or 32 fp32 columns
  constexpr int kVec = 16 / sizeof(TC);                // columns of a 16-byte store
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, cq = lane % 4;
  uint8_t* smem_base = smem_raw + (base - smem_u32(smem_raw));
  uint8_t* scratch = smem_base + L::kOutOff + warp * L::kOutWarp;
  float* cols = reinterpret_cast<float*>(smem_base + L::kColOff + wg * L::kCols);  // int8: [sb | bias]
  TAcc acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;  // each tile's first product overwrites it (scale_d 0)
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * kBM, n0 = t % n_tiles * kBN;
    // int8: this thread's four values of the tile's [sb | bias], loaded
    // before the products so that their latency is hidden
    float col_v[4];
    if constexpr (kI8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + (i % 2) * 128 + tid % 128;
        col_v[i] = n < N ? (i < 2 ? sb : bias)[n] : 0.f;
      }
    }
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 32 bytes (16 bf16 or 32 int8 columns) inside a 128-byte row a step
        const uint64_t desc_a = desc_sw128(a_tile(s) + wg * 64 * kRowBytes + kk * 32, 16);
        if constexpr (kI8) {
          wgmma_s8_ss_n256(acc, desc_a, desc_sw128(a_tile(s) + L::kA + kk * 32, 16), kb > 0 || kk > 0);
        } else {
          wgmma_ss_n256<1>(acc, desc_a, desc_sw128(a_tile(s) + L::kA + kk * 16 * kRowBytes, L::kBBox),
                           kb > 0 || kk > 0);
        }
      }
      wg_commit();
      wg_wait<1>();  // the previous k block's products are done: release its stage
      reg_fence(acc);
      if (kb > 0) mbar_arrive(empty((it - 1) % kStages));
    }
    // bf16: the bias of this thread's columns, loaded while the last
    // products run: independent loads, so a tile waits one memory latency
    // for them. int8: sa of the thread's two rows
    const int row0 = m0 + wg * 64 + (warp % 4) * 16;
    float2 bv[kI8 ? 1 : kBN / 8];
    float sa_r[2];
    if constexpr (kI8) {
#pragma unroll
      for (int r = 0; r < 2; ++r) sa_r[r] = row0 + g + 8 * r < M ? sa[row0 + g + 8 * r] : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * cq;
        bv[j] = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
      }
    }
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty((it - 1) % kStages));
    if constexpr (kI8) {  // the warpgroup's previous tile is done with cols: replace them
      named_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) cols[i * 128 + tid % 128] = col_v[i];
      named_sync(1 + wg, 128);
    }

    // the epilogue: bias (and GELU; int8: the dequantization) from
    // registers into the warp's scratch, one chunk of columns at a time,
    // then whole 128-byte row chunks to C
#pragma unroll
    for (int chunk = 0; chunk < kBN / kChunkCols; ++chunk) {
#pragma unroll
      for (int jj = 0; jj < kChunkCols / 8; ++jj) {
        const int j = chunk * (kChunkCols / 8) + jj;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint8_t* at = scratch + (g + 8 * r) * L::kOutRow + (8 * jj + 2 * cq) * sizeof(TC);
          if constexpr (kI8) {
            const int c = 8 * j + 2 * cq;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a_s = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r + e]), sa_r[r]);
              v[e] = __fadd_rn(__fmul_rn(a_s, cols[c + e]), cols[kBN + c + e]);
            }
            *reinterpret_cast<float2*>(at) = make_float2(v[0], v[1]);
          } else {
            float v0 = acc[4 * j + 2 * r] + bv[j].x, v1 = acc[4 * j + 2 * r + 1] + bv[j].y;
            if constexpr (kEpi == kBiasF32) {
              *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
            } else {
              if constexpr (kEpi == kBiasGeluBf16) {
                v0 = gelu_tanh(v0);
                v1 = gelu_tanh(v1);
              }
              *reinterpret_cast<uint32_t*>(at) = pack_bf16(v0, v1);
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 16 rows x 8 vectors of 16 bytes
        const int v = lane + 32 * i, rr = v / 8;
        const int m = row0 + rr, n = n0 + chunk * kChunkCols + (v % 8) * kVec;
        if (m < M && n < N)  // N % 8 == 0: a vector is wholly in or out
          *reinterpret_cast<uint4*>(static_cast<TC*>(c_out) + (size_t)m * N + n) =
              *reinterpret_cast<const uint4*>(scratch + rr * L::kOutRow + (v % 8) * 16);
      }
      __syncwarp();
    }
  }
}

template <int kEpi>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, const float* sa, const float* sb, const float* bias,
                   void* c, int M, int N, int K, cudaStream_t stream) {
  constexpr size_t smem = Layout::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(gemm_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // a persistent grid: one block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kBN - 1) / kBN * ((M + kBM - 1) / kBM);
  gemm_kernel<kEpi><<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(a, b, sa, sb, bias, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace
