// Log-spectral distance of clean/denoised pairs, fused.
//
// Replaces four Pallas TPU kernels of the JAX package's ops/lsd_fused.py:
//   A1 _lsd_wholesig_raw_kernel: hop-aligned raw pairs, projection scale
//      computed on the card (lsd_scores(..., denoised_scale="auto")),
//   A2 _lsd_wholesig_kernel: pre-scaled pairs of any length, F + 1 <= 1024,
//   A3 _lsd_framed_kernel: the same function, frame-blocked, F + 1 > 1024,
//   A13 _lsd_wholesig_ct_kernel: A1's function with the chunk DFT factorized
//      (lsd_scores(..., dft_impl="ct")); see fft::lsd_fft_kernel below.
// A2 and A3 compute one function and differ on the TPU only in how a row's
// chunks fit VMEM; here A1, A2 and A3 are one frame-tile kernel on the
// tensor cores (lsd_tile_kernel), A1 with the scale applied in its split
// pass (entry point fsem_lsd_wholesig_raw), A2/A3 without (fsem_lsd_wholesig).
//
// What it computes, per pair (c, d) of T samples (any T):
//   A1 only: scale = sum(c*d) / (sum(d*d) + eps);  d <- scale * d
//   centered STFT (n_fft 512, hop 256, periodic Hann, zero padding of 256
//   on each side), frames 0..F-1 with F = 1 + T / 256; per frame the mean
//   over the 257 one-sided bins of log(|C|^2 / (|D| + eps)^2 + eps)^2, its
//   square root, and the mean of that over the F frames.
// The spectra use the shared-chunk form: with hop = n_fft / 2 frame f is
// [chunk f-1 | chunk f] of the raw signal, so its spectrum is
// X_f[k] = A_{f-1}[k] + (-1)^k A_f[k] with A_j the 512-point DFT of raw
// chunk j. Chunk -1 is the left zero padding; chunk F-1 = T / 256 holds the
// signal's last T % 256 samples followed by zeros (all zeros when T is
// hop-aligned), so each chunk is transformed once. The Hann window is the
// exact 3-tap convolution Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]) in
// frequency, with X[-1] = conj X[1] and X[257] = conj X[255].
//
// What bounds it on this card: the function itself is bound by bytes. The
// signals are read once (131 MB at 64 x 16 s, 0.04 ms at 3.35 TB/s); a
// 512-point real FFT per frame and signal would need about 1.8 GFLOP in all.
// The frame-tile kernel's chunk DFT is a direct product on the bf16 tensor
// cores: 2 x 256 x 512 multiply-adds per chunk and signal, six bf16
// products each (below), 202 GFLOP at 64 x 16 s (0.20 ms at 989 TFLOP/s),
// 258 GFLOP with the tiling's 640 columns and 128 chunk rows per 127
// frames (0.26 ms): its operations set its own floor. The split pass moves
// 20 bytes per sample pair (0.10 ms at 64 x 16 s). Measured (NVIDIA H100
// 80GB HBM3, 700 W, tools/time_lsd.py): the tile kernel 0.54 ms at 64 x
// 16 s, one CTA per SM over 20 waves whose prologue and epilogue overlap
// no products; the split pass 0.11 ms.

#include <cstdint>

#include "common.cuh"
#include "sdr_halves.cuh"
#include "sm90.cuh"

namespace {

constexpr int kHop = 256;              // n_fft / 2
constexpr int kScaleSplits = 16;       // blocks per row of the scale reduction

__global__ void __launch_bounds__(256) lsd_scale_kernel(
    const float* __restrict__ c, const float* __restrict__ d,
    float* __restrict__ scale_partial, long long t_len) {
  // block (split, row) sums c*d and d*d over its slice of the row
  __shared__ float red[2][32];
  const int split = blockIdx.x, row = blockIdx.y;
  const long long per = (t_len + kScaleSplits - 1) / kScaleSplits;
  const long long lo = split * per;
  const long long hi = lo + per < t_len ? lo + per : t_len;
  const float* cr = c + row * t_len;
  const float* dr = d + row * t_len;
  float num = 0.f, den = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float dv = dr[i];
    num = fmaf(cr[i], dv, num);
    den = fmaf(dv, dv, den);
  }
  num = fsem::warp_sum(num);
  den = fsem::warp_sum(den);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = num;
    red[1][warp] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sn = 0.f, sd = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      sn += red[0][w];
      sd += red[1][w];
    }
    float* out = scale_partial + ((size_t)row * kScaleSplits + split) * 2;
    out[0] = sn;
    out[1] = sd;
  }
}

// -- A1, A2, A3: the frame-tile kernel on the tensor cores ---------------------
//
// The chunk DFT is bf16x6: x = x0 + x1 + x2 and w = w0 + w1 + w2 in three
// bf16 pieces each (the signals split once by halves::split<3>, the table on
// the host), X W ~ the six products of order <= 2^-16: x0w0, x0w1, x1w0,
// x0w2, x1w1, x2w0, each exact in float32 and summed in float32. (bf16x3,
// the JAX kernel's class, moves LSD by 2.3e-4 on a near-clean pair in a
// CPU emulation.) The five cross products run first over all 256 samples,
// the main product x0w0 last: wgmma's float32 accumulator loses low bits
// on each addition at the accumulator's magnitude, so the 96 products
// added at full magnitude in the order x0w0, x0w1, .. per 16 samples put
// A1 1.1e-4 from a float64 LSD on a near-clean pair, the 16 of this order
// 1.9e-5, beside the float32 plain version's 2.6e-5 (NVIDIA H100 80GB
// HBM3, 700 W; same time).
//
// Design: one CTA per (tile of bins, group of 127 frames, row), the
// skeleton of A10's corr_dft_kernel (sdr_corr_fused.cu). The per-frame
// mean needs all 257 bins and the Hann taps couple neighbouring bins, so a
// tile holds 62 output bins and one halo bin on each side: tile t is bins
// k = 62 t - 1 .. 62 t + 62 (64 bins = A10's n128 of [re 64 | im 64]),
// its table columns straight from the DFT formula, which gives X[-1] =
// conj X[1], the Nyquist bin and X[257] = conj X[255] with no special case;
// five tiles cover bins 0..256. A ring step holds 32 samples: the group's
// 128 clean and 128 denoised chunks (g0 - 1 .. g0 + 126; chunk -1 and
// chunks past the row from TMA's zero fill), three pieces each, and the
// tile's three table pieces, in rows of 64 bytes with the 64-byte swizzle:
// 6 x 8 + 3 x 8 KB = 72 KB, a ring of three stages (216 KB: the most that
// fits); the main product's eight steps load the first pieces only (24
// KB). A producer warpgroup (24 registers) loads the ring with TMA;
// consumer warpgroup 0 owns the clean chunk rows, 1 the denoised ones, as
// two m64n128 accumulators, and runs the wgmma m64n128k16 products. The
// epilogue writes the 256 x 128 spectra to shared
// memory over the ring (A10's swizzled layout); thread (bin column j,
// slice of 32 frames) combines chunk pairs into frame spectra with the
// sign of the absolute bin, (-1)^(62 t - 1 + j), applies the Hann taps over
// its neighbouring columns and the log ratio, and writes lr^2 of each
// output bin 62 t .. min(62 t + 61, 256) to a scratch row per frame; one
// thread per frame then adds its row in order into partial (batch, F, 5).
// lsd_tile_finalize_kernel adds each frame's five partials in tile order,
// takes the root and adds the frames in a fixed order: no float atomics,
// two launches give the same bits.
namespace tiles {

using namespace sm90;

constexpr int kOutBins = 62;              // output bins per tile
constexpr int kNB = kOutBins + 2;         // bins per tile, with a halo bin on each side
constexpr int kN = 2 * kNB;               // table columns: kNB re, then kNB im
constexpr int kTiles = 5;                 // 5 x 62 >= 257
constexpr int kFrames = 127;              // frames per group
constexpr int kRows = kFrames + 1;        // chunk rows per signal
constexpr int kPieces = 3;
constexpr int kKB = 32;                   // samples per stage: one 64-byte row (64-byte swizzle)
constexpr int kKRow = kKB * 2;            // bytes of a box row
constexpr int kKBlocks = kHop / kKB;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 3;
constexpr int kBoxA = kRows * kKRow;      // 128 chunks x 32 samples, 8 KB
constexpr int kBoxW = kN * kKRow;         // 128 table columns x 32 samples, 8 KB
// a stage: [c0 | d0 | c1 | d1 | c2 | d2 | w0 | w1 | w2]
constexpr int kStage = 2 * kPieces * kBoxA + kPieces * kBoxW;  // 72 KB
constexpr int kMainStage = 2 * kBoxA + kBoxW;                  // [c0 | d0 | . | w0 | .]: 24 KB
constexpr int kTableOff = 2 * kPieces * kBoxA;
// the spectra's rows: kN floats, the 8-float groups of row r at group
// g ^ (r % 8) (no bank conflicts for the accumulators' float2 stores nor
// the columns' reads)
__device__ __forceinline__ int swz(int row, int col) { return row * kN + (col ^ ((row & 7) << 3)); }
constexpr int kSlices = 4;                                     // frame slices of the epilogue
constexpr int kSliceFrames = (kFrames + kSlices - 1) / kSlices;  // 32
constexpr int kRedStride = kNB + 1;                            // lr^2 rows, padded: no bank conflicts
constexpr int kSpecBytes = 2 * kRows * kN * (int)sizeof(float);
constexpr int kRedBytes = kFrames * kRedStride * (int)sizeof(float);
constexpr int kBarOff = kStages * kStage;
constexpr size_t kSmem = kBarOff + 16 * kStages + 1024;  // + slack to align the base to 1 KB
static_assert(kSlices * kNB == kConsumers * 128, "one epilogue thread per (column, slice)");
static_assert(kSpecBytes + kRedBytes <= kBarOff, "the epilogue fits over the ring");
static_assert(kSmem <= 232448, "shared memory");

// grid (kTiles, n_groups, batch). tm_x: the pieces (halves::split<3>) as
// (plane x row, chunk, 256 samples); tm_w: the tile table (3 x kTiles x
// kN, 256), row (q kTiles + t) kN + n holding column n of tile t, piece q.
__global__ void __launch_bounds__(kThreads, 1)
    lsd_tile_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                    float* __restrict__ partial, int batch, int n_frames, float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto stage = [&](int s) { return base + (uint32_t)s * kStage; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tile = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int f0 = grp * kFrames;  // the group's first frame; chunk row r is chunk f0 - 1 + r

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
      for (int it = 0; it < 2 * kKBlocks; ++it) {  // the cross products' stages, then the main product's
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        const bool main_only = it >= kKBlocks;
        mbar_expect_tx(full(s), main_only ? kMainStage : kStage);
        const int k0 = (it % kKBlocks) * kKB;
        for (int q = 0; q < (main_only ? 1 : kPieces); ++q) {
#pragma unroll
          for (int sig = 0; sig < 2; ++sig)  // chunk -1 and chunks past the row: TMA's zeros
            tma_load_3d(stage(s) + (2 * q + sig) * kBoxA, &tm_x, full(s), k0, f0 - 1, (3 * sig + q) * batch + b);
          tma_load_2d(stage(s) + kTableOff + q * kBoxW, &tm_w, full(s), k0, (q * kTiles + tile) * kN);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: wg 0 the clean chunk rows, 1 the denoised ones,
  // as two m64 tiles
  setmaxnreg_inc<kConsumerRegs>();
  float acc[2][kN / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[t][i] = 0.f;  // the first product overwrites it (scale_d 0)
  // ring step it = kb (the cross products), then kKBlocks + kb (the main
  // product): wait for its loads, issue its products, then release the
  // step before it (whose products are done)
  for (int kb = 0; kb < kKBlocks; ++kb) {  // the five cross products over all 256 samples
    const int s = kb % kStages;
    mbar_wait(full(s), (kb / kStages) & 1);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 16; ++kk) {  // 16 samples (32 bytes) a product
      const uint64_t w0 = desc_sw64(stage(s) + kTableOff + kk * 32);
      const uint64_t w1 = desc_sw64(stage(s) + kTableOff + kBoxW + kk * 32);
      const uint64_t w2 = desc_sw64(stage(s) + kTableOff + 2 * kBoxW + kk * 32);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t rows = t * 64 * kKRow + kk * 32;
        const uint64_t x0 = desc_sw64(stage(s) + wg * kBoxA + rows);
        const uint64_t x1 = desc_sw64(stage(s) + (2 + wg) * kBoxA + rows);
        const uint64_t x2 = desc_sw64(stage(s) + (4 + wg) * kBoxA + rows);
        wgmma_ss_n128<0>(acc[t], x0, w1, kb > 0 || kk > 0);
        wgmma_ss_n128<0>(acc[t], x1, w0, 1);
        wgmma_ss_n128<0>(acc[t], x0, w2, 1);
        wgmma_ss_n128<0>(acc[t], x1, w1, 1);
        wgmma_ss_n128<0>(acc[t], x2, w0, 1);
      }
    }
    wg_commit();
    wg_wait<1>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    if (kb > 0) mbar_arrive(empty((kb - 1) % kStages));
  }
  for (int kb = 0; kb < kKBlocks; ++kb) {  // then the main product x0 w0
    const int it = kKBlocks + kb, s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 16; ++kk) {
      const uint64_t w0 = desc_sw64(stage(s) + kTableOff + kk * 32);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wgmma_ss_n128<0>(acc[t], desc_sw64(stage(s) + wg * kBoxA + t * 64 * kKRow + kk * 32), w0, 1);
    }
    wg_commit();
    wg_wait<1>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    mbar_arrive(empty((it - 1) % kStages));
  }
  wg_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);

  // the epilogue, over the ring (both warpgroups are done with it): spectra
  // rows 0..127 the clean chunks f0 - 1 .., 128.. the denoised ones
  named_sync(1, kConsumers * 128);
  float* sp = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  float* red = sp + 2 * kRows * kN;  // (kFrames, kRedStride): lr^2 per frame and column
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

  // thread (column j, slice sl): frames sl * 32 .. (the last slice 31 of
  // them); its columns j - 1, j, j + 1 (clamped at the halo columns, which
  // output nothing), sign (-1)^k of the absolute bin k = 62 t - 1 + c:
  // 62 t is even, so -1 on even columns
  const int j = tid % kNB, sl = tid / kNB;
  const int cols[3] = {j > 0 ? j - 1 : 0, j, j < kNB - 1 ? j + 1 : kNB - 1};
  float sgn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) sgn[i] = (cols[i] & 1) ? 1.f : -1.f;
  const int bin = tile * kOutBins - 1 + j;
  const bool out_bin = j >= 1 && j <= kOutBins && bin <= kHop;
  // chunk row r's columns of both signals: [signal][re l, c, r, im l, c, r]
  auto load = [&](int r, float (&v)[2][6]) {
#pragma unroll
    for (int sig = 0; sig < 2; ++sig)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v[sig][i] = sp[swz(sig * kRows + r, cols[i])];
        v[sig][3 + i] = sp[swz(sig * kRows + r, kNB + cols[i])];
      }
  };
  const int m_lo = sl * kSliceFrames, m_hi = min(kFrames, m_lo + kSliceFrames);
  float prev[2][6], cur[2][6];
  load(m_lo, prev);
  for (int m = m_lo; m < m_hi; ++m) {  // frame f0 + m = [chunk row m | chunk row m + 1]
    load(m + 1, cur);
    float pw[2];
#pragma unroll
    for (int sig = 0; sig < 2; ++sig) {
      float x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = prev[sig][i] + sgn[i % 3] * cur[sig][i];
      const float yr = 0.5f * x[1] - 0.25f * (x[0] + x[2]);
      const float yi = 0.5f * x[4] - 0.25f * (x[3] + x[5]);
      pw[sig] = yr * yr + yi * yi;
    }
    const float dm = sqrtf(pw[1]) + eps;
    const float lr = logf(pw[0] / (dm * dm) + eps);
    red[m * kRedStride + j] = out_bin ? lr * lr : 0.f;
#pragma unroll
    for (int sig = 0; sig < 2; ++sig)
#pragma unroll
      for (int i = 0; i < 6; ++i) prev[sig][i] = cur[sig][i];
  }
  named_sync(1, kConsumers * 128);
  if (tid < kFrames && f0 + tid < n_frames) {  // one thread per frame: its output bins in order
    float sum = 0.f;
    for (int c = 1; c <= kOutBins; ++c) sum += red[tid * kRedStride + c];
    partial[((size_t)b * n_frames + f0 + tid) * kTiles + tile] = sum;
  }
}

// One block per row: each frame's five tile partials added in tile order,
// sqrt(s / 257); the frames in a fixed order (thread i the frames i, i +
// 256, .., then the warps' butterflies and the eight warp sums in order).
__global__ void __launch_bounds__(256) lsd_tile_finalize_kernel(const float* __restrict__ partial,
                                                                float* __restrict__ out, int n_frames) {
  __shared__ float red[8];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int f = threadIdx.x; f < n_frames; f += 256) {
    const float* p = partial + ((size_t)b * n_frames + f) * kTiles;
    float bins = p[0];
#pragma unroll
    for (int t = 1; t < kTiles; ++t) bins += p[t];
    s += sqrtf(bins / (float)(kHop + 1));
  }
  s = fsem::warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < 8; ++w) total += red[w];
    out[b] = total / (float)n_frames;
  }
}

// The split pass (A1: after the scale partials), the tile kernel and the
// finalize. pieces (6, batch, ceil(t_len / 256) 256) bf16 scratch; table
// (3, kTiles kN, 256) bf16; scale_partial (batch, 16, 2) scratch, used
// when kScale; partial (batch, F, kTiles) scratch; out (batch,).
template <bool kScale>
int launch_tiles(const float* clean, const float* denoised, void* pieces, const void* table, float* scale_partial,
                 float* partial, float* out, int batch, long long t_len, float eps, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || t_len <= 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (t_len + kHop - 1) / kHop;
  const long long row_len = n_chunks * kHop;
  const long long n_frames = t_len / kHop + 1;
  const long long n_groups = (n_frames + kFrames - 1) / kFrames;
  if (n_groups > 65535 || n_frames > (1ll << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (kScale) {
    lsd_scale_kernel<<<dim3(kScaleSplits, batch), 256, 0, stream>>>(clean, denoised, scale_partial, t_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = halves::split<3, kScaleSplits>(clean, denoised, pieces, t_len, row_len, batch, true, stream, scale_partial,
                                          eps);
  } else {
    err = halves::split<3>(clean, denoised, pieces, t_len, row_len, batch, true, stream);
  }
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[3] = {(cuuint64_t)kHop, (cuuint64_t)n_chunks, (cuuint64_t)6 * batch};
  const cuuint64_t x_strides[2] = {(cuuint64_t)kHop * 2, (cuuint64_t)row_len * 2};
  const cuuint64_t w_dims[2] = {(cuuint64_t)kHop, (cuuint64_t)kPieces * kTiles * kN};
  const cuuint64_t w_strides[1] = {(cuuint64_t)kHop * 2};
  if (!tensor_map(&tm_x, pieces, 3, x_dims, x_strides, kRows, 2, kKRow) ||
      !tensor_map(&tm_w, table, 2, w_dims, w_strides, kN, 2, kKRow))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lsd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  lsd_tile_kernel<<<dim3(kTiles, (unsigned)n_groups, batch), kThreads, kSmem, stream>>>(tm_x, tm_w, partial, batch,
                                                                                      (int)n_frames, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lsd_tile_finalize_kernel<<<batch, 256, 0, stream>>>(partial, out, (int)n_frames);
  return (int)cudaGetLastError();
}

}  // namespace tiles

// -- A13: the factorized chunk DFT as a float32 FFT ----------------------------
//
// The same function as A1 (hop-aligned pairs, the projection scale computed
// here from lsd_scale_kernel's partials or given per row), with the
// 512-point DFT of each zero-padded 256-sample chunk factorized as on the
// TPU: three radix-2 DIF folds (level 1 absorbs the zero padding), then
// eight 64-point DFTs of the branches br = j1 + 2 j2 + 4 j3, with
// DFT512(x)[8 m + br] = DFT64(b_br)[m], m = 0..31 for bins 0..255, and the
// chunk Nyquist bin as the alternating sum. The TPU kernel stops there and
// runs the branch DFTs as bf16x3 matrix products; here each DFT64 is
// carried on to a float32 FFT in registers: t = 8 n1 + n2, m = k1 + 8 k2,
//   DFT64(b)[m] = sum_n2 W8^(n2 k2) W64^(n2 k1) sum_n1 W8^(n1 k1) b[8 n1 + n2],
// a radix-8 stage over n1, the 64-point twiddles, and a radix-8 stage over
// n2 of which only k2 = 0..3 (m < 32) is computed. Each DFT8 is a DIF
// radix-2 level (twiddles W8^n) and two DFT4s. About 15 k float32
// operations per chunk and signal (ops/lsd_fused.py's CT_FFT_OPS), against
// the dense branch products' 123 k (61 440 multiply-adds). Every twiddle comes from the host's tables
// (float64 rounded to float32, ops/lsd_fused.py::_ct_constants): the folds'
// from tw, the 64-point ones from w0's column m = 1 (cos | sin of
// -2 pi t / 64), the DFT8's W8^1 and W8^3 among them. The frame combine
// X_f = Z_{f-1} + (-1)^br Z_f ((-1)^k = (-1)^br for k = 8 m + br) and A1's
// Hann, the 3-tap filter over natural bins, follow in the scrambled layout
// of _ct_hann_power: X[k -+ 1] is branch br -+ 1 at the same m, except the
// carries (br 0, m) - 1 = (br 7, m - 1), whose bin 0 takes conj X[1], and
// (br 7, m) + 1 = (br 0, m + 1), whose bin 255 takes the real X[256].
// ops/lsd_fused.py::_ct_fft_reference spells out the dataflow in torch.
//
// Design: a persistent grid, two blocks of 256 threads per SM (88 KB of
// shared memory each), each walking tiles of 63 frames (chunks f0 - 1 ..
// f0 + 62: one halo chunk in 64, 1.6 % read twice), in steps of 4 chunks
// of each signal (8 items). A step's chunks are staged by cp.async,
// issued a step ahead (across tiles too), so the loads run under the
// previous step's FFTs, and the two blocks of an SM overlap one another's
// phases. Per step: (1) thread (j1, j2, item, n2) folds the 32 samples
// x[8 n1 + n2 + 64 i] into its two branches br = j1 + 2 j2 + 4 j3 at
// t = 8 n1 + n2, runs their DFT8s over n1 and writes them to shared memory
// (rows padded against bank conflicts); thread (0, 0, item, n2) also the
// chunk's Nyquist bin; (2) thread (item, br, k1) reads the 8 values over
// n2 (float4), applies the twiddles W64^(n2 k1) and writes Z[br][k1 +
// 8 k2], k2 = 0..3, into a ring of 5 chunk spectra per signal (this
// step's 4 and the one before); (3) warps w and w + 4 take frame 4 s + w - 1 of the
// tile, branches 0-3 and 4-7: lane m combines the two chunks' branches at
// its m (and the neighbour branch on each side), takes the carry
// neighbour by shuffle, and sums the log ratio over its 4 bins (lane 31 of
// the second also bin 256; the quotient by common.cuh's div_rn, the
// correctly rounded one without __fdiv_rn's branch, which is faster:
// tools/probe_lsd_fft.py); each warp's sum in a fixed butterfly, the
// frame's root of the two halves at the tile's end, the tile's 63 roots in
// a fixed order, and a second launch adds a row's tiles in order: no
// atomics, two launches give the same bits. Bound on this card: bytes, as
// A1 (0.04 ms at 64 x 16 s); the kernel's own float32 operations about 2
// GFLOP at 64 x 16 s (0.03 ms), its 257 logs, roots and divisions a frame,
// and the shared-memory traffic of its three passes.
namespace fft {

constexpr int kTileFrames = 63;           // frames per tile
constexpr int kStepChunks = 4;            // chunks of each signal per step
constexpr int kSteps = (kTileFrames + 1) / kStepChunks;  // 16: the tile's 64 chunks
constexpr int kItems = 2 * kStepChunks;   // (signal, chunk) items of a step
constexpr int kThreads = 32 * kItems;     // phase (1): 4 threads x 8 n2 an item
constexpr int kBlocksPerSm = 2;
constexpr int kXStride = kHop + 8;        // floats per staged chunk
constexpr int kYRow = 10;                 // complex per (item, branch, k1) row: n2 = 0..7, padded
constexpr int kYItem = 8 * 8 * kYRow + 8;  // complex per item, padded
constexpr int kZRow = 40;                 // complex per (slot, signal, branch) row: m = 0..31, padded
constexpr int kSlots = kStepChunks + 1;   // chunk spectra ring: a step's chunks and the one before

struct Smem {
  float x[2][kItems][kXStride];        // staged chunks, two steps
  float2 y[kItems][kYItem];            // after the first radix-8 stage: [br][k1][n2]
  float2 z[kSlots][2][8][kZRow];       // chunk spectra Z[br][m] of each signal, bin 8 m + br
  float nyq[kSlots][2];                // chunk Nyquist bins
  float2 w1[256], w2[128], w3[64], w64[64];
  float part[2][kTileFrames + 1];       // per frame: the log-ratio sums of the two branch halves
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 rmul(float a, float2 w) { return make_float2(a * w.x, a * w.y); }
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // a (-i)

// DFT8 of v in place, natural order: a DIF radix-2 level (pairs n, n + 4,
// twiddles W8^n), then a DFT4 of the sums (even outputs) and of the
// differences (odd outputs); DFT4(p) = [q0 + q1, q2 + q3, q0 - q1, q2 - q3]
// with q0 = p0 + p2, q1 = p1 + p3, q2 = p0 - p2, q3 = (p1 - p3)(-i).
// kHalf: outputs 0..3 only.
template <bool kHalf>
__device__ __forceinline__ void dft8(float2 (&v)[8], float2 w8_1, float2 w8_3) {
  const float2 a0 = cadd(v[0], v[4]), a1 = cadd(v[1], v[5]), a2 = cadd(v[2], v[6]), a3 = cadd(v[3], v[7]);
  const float2 b0 = csub(v[0], v[4]), b1 = cmul(csub(v[1], v[5]), w8_1);
  const float2 b2 = mul_mi(csub(v[2], v[6])), b3 = cmul(csub(v[3], v[7]), w8_3);
  const float2 qa0 = cadd(a0, a2), qa1 = cadd(a1, a3), qa2 = csub(a0, a2), qa3 = mul_mi(csub(a1, a3));
  const float2 qb0 = cadd(b0, b2), qb1 = cadd(b1, b3), qb2 = csub(b0, b2), qb3 = mul_mi(csub(b1, b3));
  v[0] = cadd(qa0, qa1);
  v[1] = cadd(qb0, qb1);
  v[2] = cadd(qa2, qa3);
  v[3] = cadd(qb2, qb3);
  if constexpr (!kHalf) {
    v[4] = csub(qa0, qa1);
    v[5] = csub(qb0, qb1);
    v[6] = csub(qa2, qa3);
    v[7] = csub(qb2, qb3);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n) : "memory");
}

// the 16 chunks of step s of tile `tile` of row `row` into stage buf,
// zeros for chunks before 0 or past the row
__device__ __forceinline__ void load_step(Smem& sm, int buf, const float* c, const float* d, int row, int tile,
                                          int s, int nc, int tid) {
  const size_t row_off = (size_t)row * nc * kHop;
#pragma unroll
  for (int r = 0; r < kItems * kHop / 4 / kThreads; ++r) {
    const int idx = tid + r * kThreads;  // (item, 16-byte piece)
    const int item = idx >> 6, piece = idx & 63;
    const int g = tile * kTileFrames - 1 + kStepChunks * s + item % kStepChunks;
    const bool valid = g >= 0 && g < nc;
    const float* src = (item >= kStepChunks ? d : c) + row_off + (valid ? (size_t)g * kHop + piece * 4 : 0);
    cp_async16(&sm.x[buf][item][piece * 4], src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) lsd_fft_kernel(
    const float* __restrict__ c, const float* __restrict__ d, const float* __restrict__ scale_partial,
    const float* __restrict__ scale_given, const float* __restrict__ tw, const float* __restrict__ w0,
    float* __restrict__ partial, int nc, int n_frames, int n_tiles, int total_tiles, float eps) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256; i += kThreads) {
    sm.w1[i] = make_float2(tw[i], tw[256 + i]);
    if (i < 128) sm.w2[i] = make_float2(tw[2 * 256 + i], tw[3 * 256 + i]);
    if (i < 64) {
      sm.w3[i] = make_float2(tw[4 * 256 + i], tw[5 * 256 + i]);
      sm.w64[i] = make_float2(w0[i * 64 + 1], w0[i * 64 + 33]);  // exp(-2 pi i t / 64)
    }
  }
  const int my_tiles = (total_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_items = my_tiles * kSteps;
  auto tile_of = [&](int it) { return (int)blockIdx.x + it / kSteps * (int)gridDim.x; };
  load_step(sm, 0, c, d, tile_of(0) / n_tiles, tile_of(0) % n_tiles, 0, nc, tid);
  float sc = 1.f;
  for (int it = 0; it < n_items; ++it) {
    const int t_id = tile_of(it), s = it % kSteps, row = t_id / n_tiles, tile = t_id % n_tiles;
    if (it + 1 < n_items) {
      const int t_next = tile_of(it + 1);
      load_step(sm, (it + 1) & 1, c, d, t_next / n_tiles, t_next % n_tiles, (it + 1) % kSteps, nc, tid);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (s == 0) {  // the row's scale, the same bits in every thread
      if (scale_given != nullptr) {
        sc = scale_given[row];
      } else {
        float num = 0.f, den = 0.f;
        for (int i = 0; i < kScaleSplits; ++i) {
          num += scale_partial[((size_t)row * kScaleSplits + i) * 2];
          den += scale_partial[((size_t)row * kScaleSplits + i) * 2 + 1];
        }
        sc = num / (den + eps);
      }
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float2 w8_1 = sm.w64[8], w8_3 = sm.w64[24];

    // (1) folds and the radix-8 stage over n1: thread (j1, j2, item, n2)
    // takes the branches br = j1 + 2 j2 + 4 j3, j3 = 0, 1
    {
      const int j1 = tid / (8 * kItems) & 1, j2 = tid / (16 * kItems), item = tid / 8 % kItems, n2 = tid & 7;
      const float* xs = sm.x[it & 1][item];
      const float xscale = item >= kStepChunks ? sc : 1.f;
      float x[4][8];  // x[i][n1] = x[8 n1 + n2 + 64 i]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n1 = 0; n1 < 8; ++n1) x[i][n1] = xs[8 * n1 + n2 + 64 * i] * xscale;
      float2 bv[2][8];  // branches j1 + 2 j2 (L3 sums) and j1 + 2 j2 + 4 (L3 differences) at t = 8 n1 + n2
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const int t = 8 * n1 + n2;
        const float2 w3 = sm.w3[t];
        float2 h0, h1;  // the L2 halves at t and t + 64
        if (j1 == 0) {  // b0 = x: even stays real (branch 0 real)
          if (j2 == 0) {
            h0 = make_float2(x[0][n1] + x[2][n1], 0.f);
            h1 = make_float2(x[1][n1] + x[3][n1], 0.f);
          } else {
            h0 = rmul(x[0][n1] - x[2][n1], sm.w2[t]);
            h1 = rmul(x[1][n1] - x[3][n1], sm.w2[t + 64]);
          }
        } else {  // L1: b1 = x w1, complex
          float2 b1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) b1[i] = rmul(x[i][n1], sm.w1[t + 64 * i]);
          if (j2 == 0) {
            h0 = cadd(b1[0], b1[2]);
            h1 = cadd(b1[1], b1[3]);
          } else {
            h0 = cmul(csub(b1[0], b1[2]), sm.w2[t]);
            h1 = cmul(csub(b1[1], b1[3]), sm.w2[t + 64]);
          }
        }
        bv[0][n1] = cadd(h0, h1);
        bv[1][n1] = (j1 | j2) ? cmul(csub(h0, h1), w3) : rmul(h0.x - h1.x, w3);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        dft8<false>(bv[b], w8_1, w8_3);
        float2* yr = &sm.y[item][(j1 + 2 * j2 + 4 * b) * 8 * kYRow + n2];
#pragma unroll
        for (int k1 = 0; k1 < 8; ++k1) yr[k1 * kYRow] = bv[b][k1];
      }
      if (j1 == 0 && j2 == 0) {  // the chunk's Nyquist bin: sum of (-1)^n x[n], (-1)^n = (-1)^n2 here
        float alt = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n1 = 0; n1 < 8; ++n1) alt += x[i][n1];
        alt = (n2 & 1) ? -alt : alt;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) alt += __shfl_xor_sync(fsem::kFullMask, alt, o);
        if (n2 == 0) sm.nyq[(kStepChunks * s + item % kStepChunks) % kSlots][item >= kStepChunks] = alt;
      }
    }
    __syncthreads();

    // (2) the twiddles W64^(n2 k1) and the radix-8 stage over n2, outputs
    // k2 = 0..3: thread (item, br, k1)
#pragma unroll
    for (int r = 0; r < kItems * 64 / kThreads; ++r) {
      const int item = r * (kThreads / 64) + (tid >> 6), br = (tid >> 3) & 7, k1 = tid & 7;
      const float4* yr = reinterpret_cast<const float4*>(&sm.y[item][(br * 8 + k1) * kYRow]);
      float2 v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = yr[q];
        v[2 * q] = make_float2(a.x, a.y);
        v[2 * q + 1] = make_float2(a.z, a.w);
      }
#pragma unroll
      for (int n2 = 1; n2 < 8; ++n2) v[n2] = cmul(v[n2], sm.w64[n2 * k1]);  // W64^(n2 k1)
      dft8<true>(v, w8_1, w8_3);
      float2* zr = sm.z[(kStepChunks * s + item % kStepChunks) % kSlots][item >= kStepChunks][br];
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) zr[k1 + 8 * k2] = v[k2];
    }
    __syncthreads();

    // (3) frame q - 1 of the tile (chunks q - 1 and q), q = 4 s + warp % 4,
    // branches 4 h .. 4 h + 3 of it, h = warp / 4: lane m holds bins
    // 8 m + br; it also forms the neighbour branches 4 h - 1 and 4 h + 4
    const int q = kStepChunks * s + warp % kStepChunks, h = warp / kStepChunks;
    if (q >= 1) {
      const int f = tile * kTileFrames + q - 1;
      float acc = 0.f;
      if (f < n_frames) {
        const int sa = (q - 1) % kSlots, sb = q % kSlots;
        const int m = lane;
        float2 xs[2][6];  // branches (4 h - 1 + j) & 7, j = 0..5
        float xn[2];
#pragma unroll
        for (int sig = 0; sig < 2; ++sig) {
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            const int br = (4 * h - 1 + j) & 7;
            const float2 za = sm.z[sa][sig][br][m], zb = sm.z[sb][sig][br][m];
            xs[sig][j] = (br & 1) ? csub(za, zb) : cadd(za, zb);
          }
          xn[sig] = sm.nyq[sa][sig] + sm.nyq[sb][sig];  // (-1)^256 = +1
        }
        float2 left[2], right[2];
#pragma unroll
        for (int sig = 0; sig < 2; ++sig) {
          // h = 0: bin 8 m - 1 is lane m - 1's branch 7 (bin 0: conj X[1]);
          // h = 1: bin 8 m + 8 is lane m + 1's branch 0 (bin 256: the real
          // Nyquist)
          const float2 up = make_float2(__shfl_up_sync(fsem::kFullMask, xs[sig][0].x, 1),
                                        __shfl_up_sync(fsem::kFullMask, xs[sig][0].y, 1));
          const float2 down = make_float2(__shfl_down_sync(fsem::kFullMask, xs[sig][5].x, 1),
                                          __shfl_down_sync(fsem::kFullMask, xs[sig][5].y, 1));
          left[sig] = h == 1 ? xs[sig][0] : (m == 0 ? make_float2(xs[sig][2].x, -xs[sig][2].y) : up);
          right[sig] = h == 0 ? xs[sig][5] : (m == 31 ? make_float2(xn[sig], 0.f) : down);
        }
#pragma unroll
        for (int j = 1; j <= 4; ++j) {
          float p[2];
#pragma unroll
          for (int sig = 0; sig < 2; ++sig) {
            const float2 l = j > 1 ? xs[sig][j - 1] : left[sig];
            const float2 rt = j < 4 ? xs[sig][j + 1] : right[sig];
            const float yr = 0.5f * xs[sig][j].x - 0.25f * (l.x + rt.x);
            const float yi = 0.5f * xs[sig][j].y - 0.25f * (l.y + rt.y);
            p[sig] = yr * yr + yi * yi;
          }
          const float dm = sqrtf(p[1]) + eps;
          const float dd = dm * dm;
          const float lr = logf(fsem::div_rn(p[0], dd, fsem::rcp_rn(dd)) + eps);
          acc = fmaf(lr, lr, acc);
        }
        if (h == 1 && m == 31) {  // bin 256: X[257] = conj X[255], imaginary part 0
          const float yc = 0.5f * xn[0] - 0.25f * (xs[0][4].x + xs[0][4].x);
          const float yd = 0.5f * xn[1] - 0.25f * (xs[1][4].x + xs[1][4].x);
          const float dm = sqrtf(yd * yd) + eps;
          const float dd = dm * dm;
          const float lr = logf(fsem::div_rn(yc * yc, dd, fsem::rcp_rn(dd)) + eps);
          acc = fmaf(lr, lr, acc);
        }
        acc = fsem::warp_sum(acc);
      }
      if (lane == 0) sm.part[h][q - 1] = acc;
    }
    if (s == kSteps - 1) {  // the tile's frame roots, added in a fixed order
      __syncthreads();
      if (warp == 0) {
        const int f2 = lane + 32 < kTileFrames ? lane + 32 : lane;
        const float r0 = sqrtf((sm.part[0][lane] + sm.part[1][lane]) / (float)(kHop + 1));
        const float r1 = sqrtf((sm.part[0][f2] + sm.part[1][f2]) / (float)(kHop + 1));
        float v = r0 + (lane + 32 < kTileFrames ? r1 : 0.f);
        v = fsem::warp_sum(v);
        if (lane == 0) partial[(size_t)row * n_tiles + tile] = v;
      }
    }
  }
}

}  // namespace fft

__global__ void lsd_finalize_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n_tiles,
                                    int n_frames) {
  const int b = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += 32) s += partial[(size_t)b * n_tiles + i];
  s = fsem::warp_sum(s);
  if (threadIdx.x == 0) out[b] = s / (float)n_frames;
}


}  // namespace

// A1. clean, denoised: (batch, nc * 256) float32; pieces: (6, batch, nc *
// 256) bf16 scratch; table: (3, 640, 256) bf16, the tile table's pieces
// (ops/lsd_fused.py::_tile_table_pieces); scale_partial: (batch, 16, 2)
// scratch; partial: (batch, nc + 1, 5) scratch; out: (batch,) LSD scores.
extern "C" int fsem_lsd_wholesig_raw(const float* clean, const float* denoised, void* pieces, const void* table,
                                     float* scale_partial, float* partial, float* out, int batch, int nc,
                                     float eps, void* stream_ptr) {
  if (nc <= 0) return (int)cudaErrorInvalidValue;
  return tiles::launch_tiles<true>(clean, denoised, pieces, table, scale_partial, partial, out, batch,
                                   (long long)nc * kHop, eps, static_cast<cudaStream_t>(stream_ptr));
}

// A2/A3. clean, denoised (pre-scaled): (batch, t_len) float32, any t_len;
// pieces: (6, batch, ceil(t_len / 256) 256) bf16 scratch; table as above;
// partial: (batch, t_len / 256 + 1, 5) scratch; out: (batch,) LSD scores.
extern "C" int fsem_lsd_wholesig(const float* clean, const float* denoised, void* pieces, const void* table,
                                 float* partial, float* out, int batch, long long t_len, float eps,
                                 void* stream_ptr) {
  return tiles::launch_tiles<false>(clean, denoised, pieces, table, nullptr, partial, out, batch, t_len, eps,
                                    static_cast<cudaStream_t>(stream_ptr));
}

// The split pass alone, for the card tests: pieces (6, batch, row_len)
// bf16; with scale_partial (batch, 16, 2) given, A1's scale partials are
// computed into it first and d is scaled as in fsem_lsd_wholesig_raw.
extern "C" int fsem_lsd_split(const float* clean, const float* denoised, float* scale_partial, void* pieces,
                              int batch, long long t_len, long long row_len, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch <= 0 || batch > 65535 || t_len <= 0) return (int)cudaErrorInvalidValue;
  if (scale_partial == nullptr)
    return (int)halves::split<3>(clean, denoised, pieces, t_len, row_len, batch, true, stream);
  lsd_scale_kernel<<<dim3(kScaleSplits, batch), 256, 0, stream>>>(clean, denoised, scale_partial, t_len);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)halves::split<3, kScaleSplits>(clean, denoised, pieces, t_len, row_len, batch, true, stream,
                                             scale_partial, eps);
}

// A13. clean, denoised: (batch, nc * 256) float32; scale: (batch,) float32
// or null (then computed here, as A1); tw: (8, 256) fold twiddles; w0:
// (64, 64) branch DFT cos | sin table; scale_partial: (batch, 16, 2)
// scratch; partial: (batch, ceil((nc + 1) / 63)) scratch; out: (batch,).
// clean and denoised 16-byte aligned (cp.async).
extern "C" int fsem_lsd_wholesig_ct(const float* clean, const float* denoised,
                                    const float* scale, const float* tw, const float* w0,
                                    float* scale_partial, float* partial, float* out,
                                    int batch, int nc, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch <= 0 || nc <= 0 || ((uintptr_t)clean | (uintptr_t)denoised) % 16) return (int)cudaErrorInvalidValue;
  const long long t_len = (long long)nc * kHop;
  if (scale == nullptr) {
    lsd_scale_kernel<<<dim3(kScaleSplits, batch), 256, 0, stream>>>(
        clean, denoised, scale_partial, t_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n_frames = nc + 1;
  const int n_tiles = (n_frames + fft::kTileFrames - 1) / fft::kTileFrames;
  const long long total_tiles = (long long)batch * n_tiles;
  if (total_tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fft::lsd_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(fft::Smem));
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)sms * fft::kBlocksPerSm;
  const int grid = (int)(total_tiles < slots ? total_tiles : slots);
  fft::lsd_fft_kernel<<<grid, fft::kThreads, sizeof(fft::Smem), stream>>>(
      clean, denoised, scale_partial, scale, tw, w0, partial, nc, n_frames, n_tiles, (int)total_tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lsd_finalize_kernel<<<batch, 32, 0, stream>>>(partial, out, n_tiles, n_frames);
  return (int)cudaGetLastError();
}
