// Overlap-save SDR correlations with the chunk spectra kept on chip.
//
// Replaces A10, ops/sdr_corr_fused.py of the JAX package (Pallas, TPU):
// _corr_kernel (signals padded in device memory) and _corr_kernel_raw (T a
// multiple of h, no padded copies), behind correlation_lags_fused, SDR's
// corr_impl="fused". Both are this one kernel: it reads the raw signals and
// zeroes, by a bounds check and never by a multiply, every sample outside
// [0, T), which covers the zero left pad (the chunk before chunk 0), the
// ragged tail and the groups past the last chunk.
//
// What it computes, per row b and group j of kCB = 128 windows, for the
// packed 2h-point chunk DFT W (h, 2h) = [cos 0..h-1 | cos_h | sin 1..h-1]:
//   C_m = clean chunk (j kCB - 1 + m) W, m = 0..kCB (kCB + 1 chunks)
//   D_m = denoised chunk (j kCB + m) W, m = 0..kCB-1
//   window spectra A_m = C_m + (-1)^col C_{m+1}
//   for Y_m in (C_{m+1}, D_m), column by column over bins f < h:
//     P1 = sum_m reA reY, P2 = sum_m x2A x2Y, Q = sum_m (x2A reY - reA x2Y)
// with re = column f, x2 = column h + f. The partials land in
// partial[b][j][0..5][f] (auto P1, P2, Q, then cross); the sum over groups,
// the unpack and the inverse DFT at the lags stay in PyTorch, as they are
// XLA in JAX.
//
// The chunk DFT is float32 (SIMT FMAs): the TPU kernel's bf16x3 split
// exists to reach float32 class on its matrix unit; here plain float32 is
// both simpler and tighter, as A1 chose.
//
// What bounds it on this card: the function (a correlation at 512 lags) is
// bound by bytes, 2 x 4 bytes per sample read once (0.04 ms at 64 x 16 s).
// This direct chunk DFT does 2 h x 2h multiply-adds per chunk and signal
// (69 GFLOP at 64 x 16 s, h = 512: 1.0 ms of float32 at 67 TFLOP/s), so its
// operations set its own floor.
//
// Design: one block per (32 bins, group, row). The block's product is the
// group's 128 clean and 128 denoised chunks (256 x h) times the 32 bins' 64
// packed columns (h x 64), K in steps of 16 through shared memory: the
// chunk tile transposed (sample-major) so that each thread reads its 8 rows
// and 8 columns as four 16-byte loads and keeps an 8 x 8 tile of the
// spectra in registers; the next step's samples and table values are
// fetched into registers while the current step computes. The clean chunk
// before the group (row 0 of the spectra) is one more row, which 64 threads
// add as a dot product per column. The 257 x 64 spectra then go to shared
// memory, thread (f, slice) sums its 16 windows' six products, and the 8
// slices are added in a fixed order. The spectra never reach device memory.
// Each block re-reads its group's chunks for every bin tile (from L2), and
// no tensor cores.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCB = 128;             // windows per group
constexpr int kRowsC = kCB + 1;      // clean chunk rows of a group's spectra
constexpr int kRows = kRowsC + kCB;  // + denoised rows = 257
constexpr int kMain = 2 * kCB;       // rows of the tiled product: 128 clean, 128 denoised chunks
constexpr int kNB = 32;              // bins per block
constexpr int kCols = 2 * kNB;       // packed columns per block
constexpr int kKStep = 16;           // samples per step of the product
constexpr int kThreads = 256;
constexpr int kT = 4;                             // a thread: 2 x kT rows, 2 x kT columns
constexpr int kColGroups = kNB / kT;              // 8
constexpr int kRowGroups = kThreads / kColGroups;  // 32
static_assert(kRowGroups * kT == kCB, "row tiling");
constexpr int kLdX = kMain + 4;  // transposed chunk tile (kKStep, kLdX)
constexpr int kLdS = kCols + 1;
constexpr int kSlices = kThreads / kNB;      // 8
constexpr int kWinPerSlice = kCB / kSlices;  // 16
constexpr int kOut = 6;
constexpr int kXLoads = kMain * kKStep / 4 / kThreads;  // float4 chunk loads per thread and step
constexpr int kWLoads = kKStep * kCols / kThreads;      // table loads per thread and step
constexpr size_t kTileFloats = (size_t)kKStep * kLdX + kKStep * kCols + kKStep;
constexpr size_t kSpecFloats = (size_t)kRows * kLdS + kSlices * kOut * kNB;
constexpr size_t kSmem = (kTileFloats > kSpecFloats ? kTileFloats : kSpecFloats) * sizeof(float);

// samples t .. t + 3 of one row, zero at or past t_len; vec: t and t_len are
// multiples of 4 and the row is 16-byte aligned, so the four are all in or out
__device__ __forceinline__ float4 fetch4(const float* src, long long t, long long t_len, bool vec) {
  if (vec) return t < t_len ? *reinterpret_cast<const float4*>(src + t) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(t < t_len ? src[t] : 0.f, t + 1 < t_len ? src[t + 1] : 0.f,
                     t + 2 < t_len ? src[t + 2] : 0.f, t + 3 < t_len ? src[t + 3] : 0.f);
}

__global__ void __launch_bounds__(kThreads) corr_fused_kernel(
    const float* __restrict__ c, const float* __restrict__ d, const float* __restrict__ w,
    float* __restrict__ partial, long long t_len, int h, int n_groups, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;                  // phase 1: (kKStep, kLdX) chunk tile, sample-major
  float* ws = xs + kKStep * kLdX;    // phase 1: (kKStep, kCols) table tile
  float* xe = ws + kKStep * kCols;   // phase 1: (kKStep) of the chunk before the group
  float* sp = smem;                  // phase 2: (kRows, kLdS) spectra
  float* red = smem + kRows * kLdS;  // phase 2: (kSlices, kOut, kNB)

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kNB, grp = blockIdx.y, b = blockIdx.z;
  const float* cr = c + (size_t)b * t_len;
  const float* dr = d + (size_t)b * t_len;
  const long long chunk0 = (long long)grp * kCB;
  // thread (rg, cg): product rows rg kT + i (clean) and kCB + rg kT + i
  // (denoised); columns cg kT + e (re) and kNB + cg kT + e (x2)
  const int cg = tid % kColGroups, rg = tid / kColGroups;

  float4 xr[kXLoads];
  float wr[kWLoads];
  float er = 0.f;
  auto fetch = [&](int k0) {  // one step's operands into registers
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kThreads, m = idx / (kKStep / 4), kk = (idx % (kKStep / 4)) * 4;
      const long long chunk = chunk0 + (m < kCB ? m : m - kCB);
      xr[i] = fetch4(m < kCB ? cr : dr, chunk * h + k0 + kk, t_len, vec != 0);
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads, kk = idx / kCols, n = idx % kCols;
      const int col = n < kNB ? j0 + n : h + j0 + n - kNB;
      wr[i] = w[(size_t)(k0 + kk) * 2 * h + col];
    }
    if (tid < kKStep) {  // the chunk before the group; before group 0, the zero left pad
      const long long t = (chunk0 - 1) * h + k0 + tid;
      er = (chunk0 > 0 && t < t_len) ? cr[t] : 0.f;
    }
  };
  auto stage = [&]() {  // the fetched step into shared memory
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + i * kThreads, m = idx / (kKStep / 4), kk = (idx % (kKStep / 4)) * 4;
      xs[(kk + 0) * kLdX + m] = xr[i].x;
      xs[(kk + 1) * kLdX + m] = xr[i].y;
      xs[(kk + 2) * kLdX + m] = xr[i].z;
      xs[(kk + 3) * kLdX + m] = xr[i].w;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) ws[tid + i * kThreads] = wr[i];
    if (tid < kKStep) xe[tid] = er;
  };

  float acc[2 * kT][2 * kT];
#pragma unroll
  for (int i = 0; i < 2 * kT; ++i)
#pragma unroll
    for (int e = 0; e < 2 * kT; ++e) acc[i][e] = 0.f;
  float acc_e = 0.f;  // tid < kCols: the chunk before the group, column tid

  fetch(0);
  for (int k0 = 0; k0 < h; k0 += kKStep) {
    __syncthreads();  // every thread is done with the previous step's tiles
    stage();
    __syncthreads();
    if (k0 + kKStep < h) fetch(k0 + kKStep);
#pragma unroll
    for (int kk = 0; kk < kKStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * kLdX + rg * kT);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * kLdX + kCB + rg * kT);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * kCols + cg * kT);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * kCols + kNB + cg * kT);
      const float a[2 * kT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[2 * kT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 2 * kT; ++i)
#pragma unroll
        for (int e = 0; e < 2 * kT; ++e) acc[i][e] = fmaf(a[i], bv[e], acc[i][e]);
    }
    if (tid < kCols) {
#pragma unroll
      for (int kk = 0; kk < kKStep; ++kk) acc_e = fmaf(xe[kk], ws[kk * kCols + tid], acc_e);
    }
  }
  __syncthreads();  // every thread is done with the tiles: reuse them for the spectra
  // spectra rows: 0 the chunk before the group, 1..kCB the clean chunks,
  // kRowsC.. the denoised ones
#pragma unroll
  for (int i = 0; i < 2 * kT; ++i) {
    const int row = i < kT ? 1 + rg * kT + i : kRowsC + rg * kT + i - kT;
#pragma unroll
    for (int e = 0; e < 2 * kT; ++e) sp[row * kLdS + (e < kT ? cg * kT + e : kNB + cg * kT + e - kT)] = acc[i][e];
  }
  if (tid < kCols) sp[tid] = acc_e;
  __syncthreads();

  // thread (bin f, slice s): windows s * 16 .. s * 16 + 15
  const int f = tid % kNB, s = tid / kNB;
  const float sign = ((j0 + f) & 1) ? -1.f : 1.f;  // (-1)^col; col h + f has f's parity (h even)
  float o[kOut] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = s * kWinPerSlice; r < (s + 1) * kWinPerSlice; ++r) {
    const float re0 = sp[r * kLdS + f], x20 = sp[r * kLdS + kNB + f];
    const float re1 = sp[(r + 1) * kLdS + f], x21 = sp[(r + 1) * kLdS + kNB + f];
    const float red_ = sp[(kRowsC + r) * kLdS + f], x2d = sp[(kRowsC + r) * kLdS + kNB + f];
    const float re_w = re0 + sign * re1, x2_w = x20 + sign * x21;
    o[0] += re_w * re1;
    o[1] += x2_w * x21;
    o[2] += x2_w * re1 - re_w * x21;
    o[3] += re_w * red_;
    o[4] += x2_w * x2d;
    o[5] += x2_w * red_ - re_w * x2d;
  }
#pragma unroll
  for (int q = 0; q < kOut; ++q) red[(s * kOut + q) * kNB + f] = o[q];
  __syncthreads();
  if (tid < kOut * kNB) {
    const int q = tid / kNB, ff = tid % kNB;
    float sum = 0.f;
#pragma unroll
    for (int ss = 0; ss < kSlices; ++ss) sum += red[(ss * kOut + q) * kNB + ff];
    partial[(((size_t)b * n_groups + grp) * kOut + q) * h + j0 + ff] = sum;
  }
}

}  // namespace

// clean, denoised: (batch, t_len) float32; table: (h, 2h) float32 packed
// chunk DFT; partial: (batch, n_groups, 6, h) float32 with n_groups =
// ceil(ceil(t_len / h) / 128). h % 32 == 0 and even.
extern "C" int fsem_corr_fused(const float* clean, const float* denoised, const float* table,
                               float* partial, int batch, long long t_len, int h, int n_groups,
                               void* stream_ptr) {
  if (h <= 0 || h % kNB || h % kKStep || batch <= 0 || n_groups <= 0 || t_len <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = t_len % 4 == 0 && reinterpret_cast<std::uintptr_t>(clean) % 16 == 0 &&
                  reinterpret_cast<std::uintptr_t>(denoised) % 16 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaFuncSetAttribute(corr_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  corr_fused_kernel<<<dim3(h / kNB, n_groups, batch), kThreads, kSmem, stream>>>(
      clean, denoised, table, partial, t_len, h, n_groups, vec);
  return (int)cudaGetLastError();
}
