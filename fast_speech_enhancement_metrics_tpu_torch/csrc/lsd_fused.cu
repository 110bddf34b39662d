// Log-spectral distance of clean/denoised pairs, fused.
//
// Replaces four Pallas TPU kernels of the JAX package's ops/lsd_fused.py:
//   A1 _lsd_wholesig_raw_kernel: hop-aligned raw pairs, projection scale
//      computed on the card (lsd_scores(..., denoised_scale="auto")),
//   A2 _lsd_wholesig_kernel: pre-scaled pairs of any length, F + 1 <= 1024,
//   A3 _lsd_framed_kernel: the same function, frame-blocked, F + 1 > 1024,
//   A13 _lsd_wholesig_ct_kernel: A1's function with the chunk DFT factorized
//      (lsd_scores(..., dft_impl="ct")); see lsd_ct_kernel below.
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

#include "common.cuh"
#include "sdr_halves.cuh"
#include "sm90.cuh"

namespace {

constexpr int kHop = 256;              // n_fft / 2
constexpr int kBins = kHop;            // bins 0..kHop-1 of a chunk DFT; kBins is the Nyquist bin
constexpr int kThreads = kHop;         // A13: one thread per DFT bin
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kBins + 1;        // frame spectrum row: bins 0..256
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

// Windowed power at bin k of one frame spectrum (re/im rows of kRow).
__device__ __forceinline__ float hann_power(const float* re, const float* im, int k) {
  float lr, li, rr, ri;
  if (k == 0) {  // X[-1] = conj X[1]
    lr = re[1];
    li = -im[1];
  } else {
    lr = re[k - 1];
    li = im[k - 1];
  }
  if (k == kBins) {  // X[257] = conj X[255]
    rr = re[kBins - 1];
    ri = -im[kBins - 1];
  } else {
    rr = re[k + 1];
    ri = im[k + 1];
  }
  const float yr = 0.5f * re[k] - 0.25f * (lr + rr);
  const float yi = 0.5f * im[k] - 0.25f * (li + ri);
  return yr * yr + yi * yi;
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

// -- A13: the factorized chunk DFT ----------------------------------------------
//
// The same function as A1 (hop-aligned pairs, the projection scale computed
// here from lsd_scale_kernel's partials or given per row), with the
// 512-point DFT of each zero-padded 256-sample chunk factorized as on the
// TPU: three radix-2 DIF folds (level 1 absorbs the zero padding), then
// eight 64-point DFTs of the branches br = j1 + 2 j2 + 4 j3, with
// DFT512(x)[8 m + br] = DFT64(b_br)[m], m = 0..31 for bins 0..255; branch 0
// stays real. That is 61 440 multiply-adds per chunk against A1's 131 072.
//
// Design: one block of 256 threads per (row, tile of kCtTileFrames frames),
// the kCtTileFrames + 1 chunks of both signals. (1) Folds, straight from
// device memory: one thread per (chunk, t < 64) reads x[t + 64 i], i = 0..3,
// and writes the fifteen branch values at t (the real branch 0, seven
// complex branches) to shared memory; the chunk Nyquist bins (alternating
// sums) go through shared memory too. (2) Branch DFTs: warp w is branch w,
// lane m is bin 8 m + w; every lane reads the branch's value at t as a
// broadcast and its own column of the 64 x 32 cos | sin table (the JAX
// package's w0, in shared memory), and keeps one accumulator pair per
// chunk. (3) Frame combine X_f = Z_{f-1} + (-1)^br Z_f ((-1)^k = (-1)^br for
// k = 8 m + br), written at its natural bin k: the TPU kernel's Hann in the
// scrambled layout, with its two carries between branch 0 and branch 7, is
// then A1's Hann over neighbouring bins in shared memory. (4) As A1: one
// warp per frame, the log ratio over 257 bins, the tile's sum of roots.
// Bound on this card: bytes, as A1 (0.04 ms at 64 x 16 s); its own
// operations are half of A1's, about 15.7 GFLOP at 64 x 16 s (0.24 ms).
constexpr int kCtTileFrames = 8;
constexpr int kCtChunks = kCtTileFrames + 1;  // per signal
constexpr int kCtBranch = 128;                // floats per branch: re[64] | im[64]
constexpr int kCtFoldFloats = 2 * kCtChunks * 8 * kCtBranch;
constexpr int kCtSpecFloats = 2 * 2 * kCtTileFrames * kRow;
constexpr int kCtTableFloats = 64 * 64;
constexpr int kCtSmemFloats =
    (kCtFoldFloats > kCtSpecFloats ? kCtFoldFloats : kCtSpecFloats) + kCtTableFloats;

__global__ void __launch_bounds__(kThreads) lsd_ct_kernel(
    const float* __restrict__ c, const float* __restrict__ d,
    const float* __restrict__ scale_partial, const float* __restrict__ scale_given,
    const float* __restrict__ tw, const float* __restrict__ w0, float* __restrict__ partial,
    int nc, int n_frames, int n_tiles, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* fold = smem;                                  // [2][kCtChunks][8][kCtBranch]
  float* table = smem + (kCtSmemFloats - kCtTableFloats);  // [64][64]: cos | sin
  __shared__ float nyq_part[2][kCtChunks][2];
  __shared__ float red[kWarps];
  __shared__ float s_scale;

  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f0 = tile * kCtTileFrames;
  const int g0 = f0 - 1;  // chunk index of local chunk 0
  const long long t_len = (long long)nc * kHop;
  if (tid == 0) {
    if (scale_given != nullptr) {
      s_scale = scale_given[b];
    } else {
      float num = 0.f, den = 0.f;
      for (int i = 0; i < kScaleSplits; ++i) {
        num += scale_partial[((size_t)b * kScaleSplits + i) * 2];
        den += scale_partial[((size_t)b * kScaleSplits + i) * 2 + 1];
      }
      s_scale = num / (den + eps);
    }
  }
  for (int i = tid; i < kCtTableFloats; i += kThreads) table[i] = w0[i];
  __syncthreads();
  const float sc = s_scale;

  // (1) folds: item = (signal, chunk, t); branch values at t to shared memory
  for (int item = tid; item < 2 * kCtChunks * 64; item += kThreads) {
    const int t = item & 63, sr = item >> 6;  // sr = signal * kCtChunks + chunk
    const int s = sr / kCtChunks, r = sr % kCtChunks;
    const int g = g0 + r;
    float xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (g >= 0 && g < nc) {
        const size_t off = (size_t)b * t_len + (size_t)g * kHop + t + 64 * i;
        v = s == 0 ? c[off] : d[off] * sc;
      }
      xv[i] = v;
    }
    // L1: b1 = x w1 (b0 = x); L2 pairs (t, t+128) and (t+64, t+192)
    float b1re[4], b1im[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b1re[i] = xv[i] * __ldg(tw + t + 64 * i);
      b1im[i] = xv[i] * __ldg(tw + 256 + t + 64 * i);
    }
    float e00[2], o01re[2], o01im[2], e10re[2], e10im[2], o11re[2], o11im[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // L2 position t + 64 h
      const float w2re = __ldg(tw + 2 * 256 + t + 64 * h), w2im = __ldg(tw + 3 * 256 + t + 64 * h);
      e00[h] = xv[h] + xv[h + 2];
      const float d0 = xv[h] - xv[h + 2];
      o01re[h] = d0 * w2re;
      o01im[h] = d0 * w2im;
      e10re[h] = b1re[h] + b1re[h + 2];
      e10im[h] = b1im[h] + b1im[h + 2];
      const float dre = b1re[h] - b1re[h + 2], dim = b1im[h] - b1im[h + 2];
      o11re[h] = dre * w2re - dim * w2im;
      o11im[h] = dre * w2im + dim * w2re;
    }
    // L3 pairs (t, t+64) of each 128-long half-result, twiddle w3[t]
    const float w3re = __ldg(tw + 4 * 256 + t), w3im = __ldg(tw + 5 * 256 + t);
    float* dst = fold + (size_t)sr * 8 * kCtBranch;
    dst[0 * kCtBranch + t] = e00[0] + e00[1];  // br 0, real
    const float d00 = e00[0] - e00[1];
    dst[4 * kCtBranch + t] = d00 * w3re;  // br 4
    dst[4 * kCtBranch + 64 + t] = d00 * w3im;
    auto l3c = [&](const float* vre, const float* vim, int lo_br) {  // complex: br lo_br, lo_br + 4
      dst[lo_br * kCtBranch + t] = vre[0] + vre[1];
      dst[lo_br * kCtBranch + 64 + t] = vim[0] + vim[1];
      const float dre = vre[0] - vre[1], dim = vim[0] - vim[1];
      dst[(lo_br + 4) * kCtBranch + t] = dre * w3re - dim * w3im;
      dst[(lo_br + 4) * kCtBranch + 64 + t] = dre * w3im + dim * w3re;
    };
    l3c(e10re, e10im, 1);
    l3c(o01re, o01im, 2);
    l3c(o11re, o11im, 3);
    // chunk Nyquist bin: sum over n of (-1)^n x[n], (-1)^(t + 64 i) = (-1)^t
    float alt = (xv[0] + xv[1]) + (xv[2] + xv[3]);
    alt = (t & 1) ? -alt : alt;
    alt = fsem::warp_sum(alt);  // 32 consecutive t of one (signal, chunk)
    if (lane == 0) nyq_part[s][r][t >> 5] = alt;
  }
  __syncthreads();

  // (2) branch DFTs: warp = branch br, lane = m; bin k = 8 m + br
  const int br = warp, m = lane;
  float acc_re[2][kCtChunks], acc_im[2][kCtChunks];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < kCtChunks; ++r) {
      acc_re[s][r] = 0.f;
      acc_im[s][r] = 0.f;
    }
  const float* fb = fold + br * kCtBranch;
  for (int t = 0; t < 64; ++t) {
    const float cw = table[t * 64 + m], sw = table[t * 64 + 32 + m];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < kCtChunks; ++r) {
        const float* v = fb + (size_t)(s * kCtChunks + r) * 8 * kCtBranch;
        const float vre = v[t];
        if (br == 0) {  // real branch
          acc_re[s][r] = fmaf(vre, cw, acc_re[s][r]);
          acc_im[s][r] = fmaf(vre, sw, acc_im[s][r]);
        } else {  // Re += re c - im s, Im += re s + im c
          const float vim = v[64 + t];
          acc_re[s][r] = fmaf(vre, cw, fmaf(-vim, sw, acc_re[s][r]));
          acc_im[s][r] = fmaf(vre, sw, fmaf(vim, cw, acc_im[s][r]));
        }
      }
  }
  __syncthreads();  // every warp is done with the folds: reuse the space

  // (3) frame spectra at their natural bins, k = 8 m + br
  float* spec_re = smem;
  float* spec_im = smem + 2 * kCtTileFrames * kRow;
  const int k = 8 * m + br;
  const float sgn = (br & 1) ? -1.f : 1.f;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < kCtTileFrames; ++f) {
      spec_re[(s * kCtTileFrames + f) * kRow + k] = acc_re[s][f] + sgn * acc_re[s][f + 1];
      spec_im[(s * kCtTileFrames + f) * kRow + k] = acc_im[s][f] + sgn * acc_im[s][f + 1];
    }
  if (tid < 2 * kCtTileFrames) {  // Nyquist bin: (-1)^256 = +1, imaginary part 0
    const int s = tid / kCtTileFrames, f = tid % kCtTileFrames;
    const float q0 = nyq_part[s][f][0] + nyq_part[s][f][1];
    const float q1 = nyq_part[s][f + 1][0] + nyq_part[s][f + 1][1];
    spec_re[(s * kCtTileFrames + f) * kRow + kBins] = q0 + q1;
    spec_im[(s * kCtTileFrames + f) * kRow + kBins] = 0.f;
  }
  __syncthreads();

  // (4) per frame: mean over bins of the squared log ratio, then its sqrt
  float total = 0.f;
  for (int f = warp; f < kCtTileFrames && f0 + f < n_frames; f += kWarps) {
    const float* cre = spec_re + f * kRow;
    const float* cim = spec_im + f * kRow;
    const float* dre = spec_re + (kCtTileFrames + f) * kRow;
    const float* dim = spec_im + (kCtTileFrames + f) * kRow;
    float acc = 0.f;
    for (int kk = lane; kk <= kBins; kk += 32) {
      const float pc = hann_power(cre, cim, kk);
      const float pd = hann_power(dre, dim, kk);
      const float dm = sqrtf(pd) + eps;
      const float lr = logf(pc / (dm * dm) + eps);
      acc = fmaf(lr, lr, acc);
    }
    acc = fsem::warp_sum(acc);
    total += sqrtf(acc / (float)(kBins + 1));
  }
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w];
    partial[(size_t)b * n_tiles + tile] = sum;
  }
}

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
// scratch; partial: (batch, ceil((nc + 1) / 8)) scratch; out: (batch,).
extern "C" int fsem_lsd_wholesig_ct(const float* clean, const float* denoised,
                                    const float* scale, const float* tw, const float* w0,
                                    float* scale_partial, float* partial, float* out,
                                    int batch, int nc, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long t_len = (long long)nc * kHop;
  if (scale == nullptr) {
    lsd_scale_kernel<<<dim3(kScaleSplits, batch), 256, 0, stream>>>(
        clean, denoised, scale_partial, t_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n_frames = nc + 1;
  const int n_tiles = (n_frames + kCtTileFrames - 1) / kCtTileFrames;
  const size_t smem = kCtSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lsd_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  lsd_ct_kernel<<<dim3(n_tiles, batch), kThreads, smem, stream>>>(
      clean, denoised, scale_partial, scale, tw, w0, partial, nc, n_frames, n_tiles, eps);
  lsd_finalize_kernel<<<batch, 32, 0, stream>>>(partial, out, n_tiles, n_frames);
  return (int)cudaGetLastError();
}
