// Overlap-save SDR correlations with the chunk spectra kept on chip; the
// chunk DFT on Hopper's tensor cores (bf16x3 wgmma, TMA).
//
// Replaces A10, ops/sdr_corr_fused.py of the JAX package (Pallas, TPU):
// _corr_kernel (signals padded in device memory) and _corr_kernel_raw (T a
// multiple of h, no padded copies), behind correlation_lags_fused, SDR's
// corr_impl="fused". Both are this one kernel: the zero left pad (the
// chunk before chunk 0) and the ragged tail come from TMA's zero fill and
// the zero-padded halves, never from a multiply.
//
// What it computes, per row b and group j of kWin = 127 windows, for the
// packed 2h-point chunk DFT W (h, 2h) = [cos 0..h-1 | cos_h | sin 1..h-1]:
//   C_m = clean chunk (j kWin - 1 + m) W, m = 0..kWin
//   D_m = denoised chunk (j kWin + m) W, m = 0..kWin-1
//   window spectra A_m = C_m + (-1)^col C_{m+1}
//   for Y_m in (C_{m+1}, D_m), column by column over bins f < h:
//     P1 = sum_m reA reY, P2 = sum_m x2A x2Y, Q = sum_m (x2A reY - reA x2Y)
// with re = column f, x2 = column h + f. The partials land in
// partial[b][j][0..5][f] (auto P1, P2, Q, then cross); the sum over groups,
// the unpack and the inverse DFT at the lags stay in PyTorch, as they are
// XLA in JAX. A group is 127 windows, not the JAX kernel's 128, so that its
// 128 clean chunks (the one before it and 127 of its own) and 128 denoised
// chunks (one past it, unused) fill four m64 tiles; the sum over groups
// only reorders.
//
// The chunk DFT is bf16x3, as the TPU kernel's: x = xh + xl, W = wh + wl
// (bf16 halves, the table's split once on the host), X W ~ xh wh + xh wl +
// xl wh, each product exact in float32 and summed in float32.
//
// What bounds it on this card: the tensor cores. The chunk DFT is
// 2 x 3 x h x 2h operations per chunk and signal (201 GFLOP at 64 x 16 s,
// h = 512: 0.20 ms at 989 TFLOP/s); the function's bytes (the signals read
// once) are 0.04 ms, and the split pass (sdr_halves.cuh) about 0.08 ms.
//
// Design: one CTA per (64 bins, group, row). The host permutes the table's
// columns so that a bin tile's 64 re and 64 x2 columns are one 128-row
// block of the K-major (transposed) table, and splits it into wh and wl.
// A stage holds 32 samples: the group's clean and denoised chunks, hi and
// lo (four 128-row boxes, K-major), and the tile's wh and wl (two 128-row
// boxes), in rows of 64 bytes with the 64-byte swizzle: 48 KB, a ring of
// four (two stages of 64 samples, 96 KB each, left one stage of loads
// ahead of the products and ran 1.22x slower on an H100). A
// producer warpgroup (24 registers) loads it with TMA; consumer warpgroup
// 0 owns the 128 clean rows, 1 the 128 denoised ones, each as two m64n128
// accumulators (128 float32 registers), and runs the three wgmma
// m64n128k16 products of each half pair per 16 samples. The epilogue
// writes the 256 x 128 spectra to shared memory over the ring (8-float
// groups swizzled by row, so that neither the float2 stores nor the bins'
// reads conflict); thread (bin f, slice s) sums its 32 windows' six
// products, and the four slices are added in a fixed order. The spectra
// never reach device memory; no float atomics.
#include "sdr_halves.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWin = 127;           // windows per group
constexpr int kRows = 128;          // chunk rows per consumer warpgroup
constexpr int kNB = 64;             // bins per CTA
constexpr int kN = 2 * kNB;         // packed columns: kNB re, then kNB x2
constexpr int kKB = 32;             // samples per stage: one 64-byte row (64-byte swizzle)
constexpr int kKRow = kKB * 2;      // bytes of a box row
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 4;
constexpr int kBoxA = kRows * kKRow;  // 128 chunks x 32 samples, 8 KB
constexpr int kBoxW = kN * kKRow;     // 128 table columns x 32 samples, 8 KB
// a stage: [clean hi | denoised hi | clean lo | denoised lo | wh | wl]
constexpr int kStage = 4 * kBoxA + 2 * kBoxW;  // 48 KB
// the spectra's rows: kN floats, the 8-float groups of row r at group
// g ^ (r % 8) (no bank conflicts for the accumulators' float2 stores nor
// the bins' reads)
__device__ __forceinline__ int swz(int row, int col) { return row * kN + (col ^ ((row & 7) << 3)); }
constexpr int kSlices = 128 * kConsumers / kNB;  // 4
constexpr int kWinPerSlice = (kWin + kSlices - 1) / kSlices;  // 32
constexpr int kOut = 6;
constexpr int kSpecBytes = 2 * kRows * kN * (int)sizeof(float);
constexpr int kRedBytes = kSlices * kOut * kNB * (int)sizeof(float);
constexpr int kBarOff = kStages * kStage;
constexpr size_t kSmem = kBarOff + 16 * kStages + 1024;  // + slack to align the base to 1 KB
static_assert(kSpecBytes + kRedBytes <= kBarOff, "the epilogue fits over the ring");
static_assert(kSmem <= 232448, "shared memory");

// grid (h / kNB, n_groups, batch). tm_x: the halves (sdr_halves.cuh) as
// (plane x row, chunk, h samples); tm_w: the table halves (2 x 2h, h), row
// hh 2h + n holding column n of the permuted table, half hh (wh, wl).
__global__ void __launch_bounds__(kThreads, 1)
    corr_dft_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                    float* __restrict__ partial, int batch, int h, int n_groups) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto stage = [&](int s) { return base + (uint32_t)s * kStage; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tile = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int k_blocks = h / kKB;
  const int chunk0 = grp * kWin;

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
      for (int kb = 0; kb < k_blocks; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(empty(s), ((kb / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStage);
        const int k0 = kb * kKB;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // clean chunks chunk0 - 1 ..: before the first group, TMA's zeros
          tma_load_3d(stage(s) + (2 * hh) * kBoxA, &tm_x, full(s), k0, chunk0 - 1, hh * batch + b);
          tma_load_3d(stage(s) + (2 * hh + 1) * kBoxA, &tm_x, full(s), k0, chunk0, (2 + hh) * batch + b);
          tma_load_2d(stage(s) + 4 * kBoxA + hh * kBoxW, &tm_w, full(s), k0, hh * 2 * h + tile * kN);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: wg 0 the clean rows, 1 the denoised ones, as two
  // m64 tiles
  setmaxnreg_inc<kConsumerRegs>();
  float acc[2][kN / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[t][i] = 0.f;  // the first product overwrites it (scale_d 0)
  for (int kb = 0; kb < k_blocks; ++kb) {
    const int s = kb % kStages;
    mbar_wait(full(s), (kb / kStages) & 1);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 16; ++kk) {  // 16 samples (32 bytes) a product
      const uint64_t wh = desc_sw64(stage(s) + 4 * kBoxA + kk * 32);
      const uint64_t wl = desc_sw64(stage(s) + 4 * kBoxA + kBoxW + kk * 32);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t rows = t * 64 * kKRow + kk * 32;
        const uint64_t xh = desc_sw64(stage(s) + wg * kBoxA + rows);
        const uint64_t xl = desc_sw64(stage(s) + (2 + wg) * kBoxA + rows);
        wgmma_ss_n128<0>(acc[t], xh, wh, kb > 0 || kk > 0);
        wgmma_ss_n128<0>(acc[t], xh, wl, 1);
        wgmma_ss_n128<0>(acc[t], xl, wh, 1);
      }
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: release it
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    if (kb > 0) mbar_arrive(empty((kb - 1) % kStages));
  }
  wg_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);

  // the epilogue, over the ring (both warpgroups are done with it): spectra
  // rows 0..127 the clean chunks C_0.., 128.. the denoised ones
  named_sync(1, kConsumers * 128);
  float* sp = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  float* red = sp + 2 * kRows * kN;  // (kSlices, kOut, kNB)
  const int lane = tid % 32, warp = (tid / 32) % 4, gq = lane / 4, cq = lane % 4;
  // accumulator register 4 j + e: row 16 warp + gq + 8 (e / 2) of the
  // tile's 64, column 8 j + 2 cq + e % 2
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg * kRows + t * 64 + 16 * warp + gq + 8 * r;
        *reinterpret_cast<float2*>(sp + swz(row, 8 * j + 2 * cq)) =
            make_float2(acc[t][4 * j + 2 * r], acc[t][4 * j + 2 * r + 1]);
      }
  named_sync(1, kConsumers * 128);

  // thread (bin f, slice sl): windows sl * 32 .. (the last slice 31 of them)
  const int f = tid % kNB, sl = tid / kNB;
  const float sign = (f & 1) ? -1.f : 1.f;  // (-1)^col: the tile starts at an even bin, col h + f has f's parity
  float o[kOut] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int m_end = min(kWin, (sl + 1) * kWinPerSlice);
  for (int m = sl * kWinPerSlice; m < m_end; ++m) {
    const float re0 = sp[swz(m, f)], x20 = sp[swz(m, kNB + f)];
    const float re1 = sp[swz(m + 1, f)], x21 = sp[swz(m + 1, kNB + f)];
    const float red_ = sp[swz(kRows + m, f)], x2d = sp[swz(kRows + m, kNB + f)];
    const float re_w = re0 + sign * re1, x2_w = x20 + sign * x21;
    o[0] += re_w * re1;
    o[1] += x2_w * x21;
    o[2] += x2_w * re1 - re_w * x21;
    o[3] += re_w * red_;
    o[4] += x2_w * x2d;
    o[5] += x2_w * red_ - re_w * x2d;
  }
#pragma unroll
  for (int q = 0; q < kOut; ++q) red[(sl * kOut + q) * kNB + f] = o[q];
  named_sync(1, kConsumers * 128);
  for (int idx = tid; idx < kOut * kNB; idx += kConsumers * 128) {
    const int q = idx / kNB, ff = idx % kNB;
    float sum = 0.f;
#pragma unroll
    for (int ss = 0; ss < kSlices; ++ss) sum += red[(ss * kOut + q) * kNB + ff];
    partial[(((size_t)b * n_groups + grp) * kOut + q) * h + tile * kNB + ff] = sum;
  }
}

}  // namespace

// clean, denoised: (batch, t_len) float32; halves: (4, batch, ceil(t_len /
// h) h) bf16 scratch; table: (2, 2h, h) bf16, the packed chunk DFT's
// columns permuted per 64-bin tile ([re f0.. | x2 f0..]) and transposed,
// hi then lo; partial: (batch, n_groups, 6, h) float32 with n_groups =
// ceil(ceil(t_len / h) / 127). h % 64 == 0.
extern "C" int fsem_corr_fused(const float* clean, const float* denoised, void* halves, const void* table,
                               float* partial, int batch, long long t_len, int h, int n_groups,
                               void* stream_ptr) {
  if (h <= 0 || h % kNB || h % kKB || batch <= 0 || batch > 65535 || t_len <= 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (t_len + h - 1) / h;
  if (n_groups != (n_chunks + kWin - 1) / kWin || n_groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long row_len = n_chunks * h;
  cudaError_t err = halves::split(clean, denoised, halves, t_len, row_len, batch, true, stream);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[3] = {(cuuint64_t)h, (cuuint64_t)n_chunks, (cuuint64_t)4 * batch};
  const cuuint64_t x_strides[2] = {(cuuint64_t)h * 2, (cuuint64_t)row_len * 2};
  const cuuint64_t w_dims[2] = {(cuuint64_t)h, (cuuint64_t)4 * h};
  const cuuint64_t w_strides[1] = {(cuuint64_t)h * 2};
  if (!tensor_map(&tm_x, halves, 3, x_dims, x_strides, kRows, 2, kKRow) ||
      !tensor_map(&tm_w, table, 2, w_dims, w_strides, kN, 2, kKRow))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(corr_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  corr_dft_kernel<<<dim3(h / kNB, n_groups, batch), kThreads, kSmem, stream>>>(tm_x, tm_w, partial, batch, h,
                                                                              n_groups);
  return (int)cudaGetLastError();
}
