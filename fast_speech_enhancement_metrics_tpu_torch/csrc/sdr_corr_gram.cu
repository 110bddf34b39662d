// Auto- and cross-correlation of clean/denoised pairs at 512 lags, as
// shifted Gram matrices on Hopper's tensor cores (bf16 wgmma, TMA).
//
// Replaces: ops/sdr_corr_gram.py::_gram_kernel of the JAX package (Pallas,
// TPU), the kernel behind correlation_lags_gram(..., split=) that SDR uses
// on one device, in its three split modes.
//
// What it computes, per pair (c, d) of T samples, for l = 0..511:
//   r_auto[l]  = sum_t c[t - l] * c[t]
//   r_cross[l] = sum_t c[t - l] * d[t]
// with zeros outside 0..T-1, as the TPU kernel does: frames C[f, i] =
// c[128 f + i] and Y[f, j] for Y in {C, D} (the signal zero-padded to whole
// frames), the shifted Grams G_s[i, j] = sum_f C[f, i] Y[f + s, j] for
// s = 0..4, and
//   r[128 a + b] = sum_i G_a[i, i + b]        (i + b < 128)
//                + sum_i G_{a+1}[i, i + b - 128]  (i + b >= 128).
// Each product is formed from the bf16 halves hi = bf16(x), lo = bf16(x -
// hi), K-stacked as the JAX kernel stacks them: split x1 [ch] . [yh], x3
// [ch, ch, cl] . [yh, yl, yh], x4 [ch, ch, cl, cl] . [yh, yl, yh, yl]. A
// bf16 x bf16 product is exact in float32, so x3 and x1 are the reference's
// functions up to the order of the sums, and x4 is the TPU's four-term
// class (each operand to about 16 significant bits).
//
// What bounds it on this card: the tensor cores. One bf16 pass is
// 2 x 128 x 1280 x F x B operations (41.9 GFLOP at 64 x 16 s, 0.042 ms at
// 989 TFLOP/s); x3 three passes, x4 four. The signals themselves are 0.04
// ms of bytes, and the split pass (sdr_halves.cuh) reads them once and
// writes the halves once (0.06 ms of bytes for x1's hi planes, 0.08 ms for
// all four).
//
// Design. The halves are split once, up front, into zero-padded rows
// (sdr_halves.cuh), which one 3-D TMA map reads as (plane x row, frame,
// 128 columns); frames past the row's end load as TMA's zeros. An item is
// one row, a 256-column tile of N = [C_0..C_4 | D_0..D_4] (two of the ten
// 128-column blocks (signal, shift)) and a range of frames (K); a
// persistent grid of one CTA per SM walks the items. A is C^T (M = i,
// K = f) and B is Y shifted (K = f, N = j): both MN-major, read by wgmma
// with the descriptor's transpose bits from 128-byte-swizzled boxes of 64
// columns. A stage holds, per half the split needs, kFr + 8 frames of the
// clean signal and, for the tiles with a denoised block, of the denoised
// one; A and every shifted B are views of these boxes, B of shift s
// starting s rows in (wgmma swizzles absolute shared-memory addresses, as
// TMA writes them, so a view may start on any 128-byte row of a box that
// starts on a 1 KB boundary). x1 takes 64 frames a stage of the hi planes,
// x3 / x4 32 frames of hi and lo, and the K-stacked terms are products of
// the same stage. A producer warpgroup (24 registers) keeps a ring of 4
// stages in flight and runs ahead into the next item; two consumer
// warpgroups (240 registers) own 64 rows (i) each and run wgmma m64n128k16
// into two 64-register accumulators, one per block. The epilogue is per
// warpgroup, on a scratch of its own beside the ring: each block's 64 x 128
// accumulators through shared memory (8-float groups swizzled by row, so
// that neither the float2 stores nor the reads conflict), then thread b
// sums the diagonals b and b - 128 over the warpgroup's rows in a fixed
// order, written as partial[row][k range][block][row half][upper /
// lower][b]. A second, small launch adds the k ranges and row halves in a
// fixed order and combines the blocks. No float atomics: a launch gives
// the same bits every time.
#include "sdr_halves.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kLags = 512;
constexpr int kHB = 128;                       // frame length, lag block
constexpr int kShifts = kLags / kHB + 1;       // shifted operands s = 0..4
constexpr int kBlocks = 2 * kShifts;           // 128-column blocks of N
constexpr int kTileBlocks = 2;                 // blocks of a CTA
constexpr int kNTiles = kBlocks / kTileBlocks;  // 5
constexpr int kConsumers = 2;                  // warpgroups of 64 rows (i)
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 4;
// the epilogue's scratch: a warpgroup's 64 rows of one block, 128 floats
// a row, the 8-float groups of row r at group g ^ (r % 8) (no bank
// conflicts for the accumulators' float2 stores nor the diagonals' reads)
constexpr int kEpiWG = 64 * kHB * (int)sizeof(float);
__device__ __forceinline__ int swz(int row, int col) { return row * kHB + (col ^ ((row & 7) << 3)); }

template <int kSplit>
struct Cfg {
  static constexpr int kHalves = kSplit == 1 ? 1 : 2;
  static constexpr int kFr = kSplit == 1 ? 64 : 32;    // frames per stage
  static constexpr int kRows = kFr + 8;                // + the shifts' frames, whole 1 KB atoms
  static constexpr int kBox = kRows * kRowBytes;       // 64 columns x kRows frames
  static constexpr int kSig = 2 * kBox;                // one signal's half: columns 0..63, 64..127
  static constexpr int kStage = 2 * kHalves * kSig;    // [clean, denoised] x halves
  static constexpr int kEpiOff = kStages * kStage;     // the epilogue's own space: the ring runs on
  static constexpr int kBarOff = kEpiOff + kConsumers * kEpiWG;
  static constexpr size_t kBytes = kBarOff + 16 * kStages + 1024;  // + slack to align the base to 1 KB
  static_assert(kBytes <= 232448, "shared memory");
  static_assert(kBox % 1024 == 0, "swizzle atoms");
};

// A persistent grid: CTA x takes the items x, x + gridDim.x, ... of
// kNTiles x n_splits x batch, the tile fastest. Item (tile, split, row):
// frames [split * split_frames, + split_frames) of the row; planes of the
// map: 0 clean hi, 1 clean lo, 2 denoised hi, 3 denoised lo, each `batch`
// rows.
template <int kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(const __grid_constant__ CUtensorMap tm, float* __restrict__ partial, int batch, int frames,
                int split_frames, int n_splits) {
  using L = Cfg<kSplit>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  // stage s, signal y (0 clean, 1 denoised), half h (0 hi, 1 lo)
  auto box = [&](int s, int y, int h) { return base + (uint32_t)s * L::kStage + (y * L::kHalves + h) * L::kSig; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int items = kNTiles * n_splits * batch;
  // an item's tile, row, frames and stages
  struct Item {
    int ntile, split, b, f_begin, k_blocks;
  };
  auto item_of = [&](int item) {
    Item it;
    it.ntile = item % kNTiles;
    it.split = item / kNTiles % n_splits;
    it.b = item / (kNTiles * n_splits);
    it.f_begin = it.split * split_frames;
    it.k_blocks = (min(frames, it.f_begin + split_frames) - it.f_begin + L::kFr - 1) / L::kFr;
    return it;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load, running ahead into the next item
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * 128) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it = item_of(item);
        // the tile's blocks (signal, shift): tiles 2.. read the denoised signal too
        const int signals = kTileBlocks * it.ntile + 1 >= kShifts ? 2 : 1;
        for (int kb = 0; kb < it.k_blocks; ++kb, ++n) {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(empty(s), ((n / kStages) - 1) & 1);
          mbar_expect_tx(full(s), signals * L::kHalves * L::kSig);
          const int f0 = it.f_begin + kb * L::kFr;
          // frames f0 .. f0 + kRows - 1 of each signal half the tile reads:
          // A and every shifted B are views of these boxes
          for (int y = 0; y < signals; ++y)
#pragma unroll
            for (int h = 0; h < L::kHalves; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                tma_load_3d(box(s, y, h) + c * L::kBox, &tm, full(s), c * 64, f0, (2 * y + h) * batch + it.b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: i = wg * 64 .. + 64, the two blocks' 256 columns
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid % 32, warp = (tid / 32) % 4, gq = lane / 4, cq = lane % 4, off = tid % 128;
  float* stg = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::kEpiOff + wg * kEpiWG);
  float acc[kTileBlocks][kHB / 2];
#pragma unroll
  for (int t = 0; t < kTileBlocks; ++t)
#pragma unroll
    for (int i = 0; i < kHB / 2; ++i) acc[t][i] = 0.f;  // each item's first product overwrites it (scale_d 0)
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_of(item);
    const int g0 = kTileBlocks * it.ntile;
    const int y_of[kTileBlocks] = {g0 / kShifts, (g0 + 1) / kShifts};
    const int sh_of[kTileBlocks] = {g0 % kShifts, (g0 + 1) % kShifts};
    for (int kb = 0; kb < it.k_blocks; ++kb, ++n) {
      const int s = n % kStages;
      mbar_wait(full(s), (n / kStages) & 1);
#pragma unroll
      for (int t = 0; t < kTileBlocks; ++t) reg_fence(acc[t]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < L::kFr / 16; ++kk) {  // 16 frames a product
        const uint32_t koff = kk * 16 * kRowBytes;
#pragma unroll
        for (int term = 0; term < kSplit; ++term) {  // (hi, hi), (hi, lo), (lo, hi), (lo, lo)
          const int ha = term >> 1, hb = term & 1;
          const uint64_t desc_a = desc_sw128(box(s, 0, ha) + wg * L::kBox + koff, L::kBox);
#pragma unroll
          for (int t = 0; t < kTileBlocks; ++t) {
            // shift s: the view s rows into the box (sm90.cuh, desc_sw128)
            const uint64_t desc_b = desc_sw128(box(s, y_of[t], hb) + sh_of[t] * kRowBytes + koff, L::kBox);
            wgmma_ss_n128<1, 1>(acc[t], desc_a, desc_b, kb > 0 || kk > 0 || term > 0);
          }
        }
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int t = 0; t < kTileBlocks; ++t) reg_fence(acc[t]);
      if (kb > 0) mbar_arrive(empty((n - 1) % kStages));
    }
    wg_wait<0>();
#pragma unroll
    for (int t = 0; t < kTileBlocks; ++t) reg_fence(acc[t]);
    mbar_arrive(empty((n - 1) % kStages));

    // the epilogue, per warpgroup (its 64 rows of each block), while the
    // producer loads the next item: the block through the warpgroup's
    // scratch, then thread off sums the upper diagonal off and the lower
    // one off - 128 over the rows, i ascending
    float* out = partial + (((size_t)it.b * n_splits + it.split) * kBlocks + g0) * 2 * 2 * kHB + wg * 2 * kHB;
#pragma unroll
    for (int t = 0; t < kTileBlocks; ++t) {
      named_sync(1 + wg, 128);  // the previous block's sums are read
      // accumulator register 4 j + e: row 16 warp + gq + 8 (e / 2) of the
      // warpgroup's 64, column 8 j + 2 cq + e % 2 of the block
#pragma unroll
      for (int j = 0; j < kHB / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(stg + swz(16 * warp + gq + 8 * r, 8 * j + 2 * cq)) =
              make_float2(acc[t][4 * j + 2 * r], acc[t][4 * j + 2 * r + 1]);
      named_sync(1 + wg, 128);
      float up = 0.f, low = 0.f;
#pragma unroll 8
      for (int r = 0; r < 64; ++r) {
        const int i = wg * 64 + r;
        const float v = stg[swz(r, (i + off) & (kHB - 1))];
        const bool upper = i + off < kHB;
        up += upper ? v : 0.f;
        low += upper ? 0.f : v;
      }
      out[t * 2 * 2 * kHB + off] = up;
      out[t * 2 * 2 * kHB + kHB + off] = low;
    }
  }
}

// partial (batch, n_splits, kBlocks, 2 row halves, 2, kHB): r[128 a + bb] =
// the sum over the k ranges and row halves, in order, of U_a[bb] + L_{a+1}[bb]
__global__ void gram_finalize_kernel(const float* __restrict__ partial, float* __restrict__ r_auto,
                                     float* __restrict__ r_cross, int n_splits) {
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < 2 * kLags; o += blockDim.x) {
    const int y = o / kLags, lag = o % kLags, a = lag / kHB, bb = lag % kHB;
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) {
      const float* p = partial + ((size_t)b * n_splits + k) * kBlocks * 2 * 2 * kHB;
#pragma unroll
      for (int w = 0; w < 2; ++w)
        s += p[(((y * kShifts + a) * 2 + w) * 2 + 0) * kHB + bb] +
             p[(((y * kShifts + a + 1) * 2 + w) * 2 + 1) * kHB + bb];
    }
    (y ? r_cross : r_auto)[(size_t)b * kLags + lag] = s;
  }
}

template <int kSplit>
cudaError_t launch_gram(const CUtensorMap& tm, float* partial, int batch, int frames, int split_frames,
                        int n_splits, cudaStream_t stream) {
  constexpr size_t smem = Cfg<kSplit>::kBytes;
  if (split_frames % Cfg<kSplit>::kFr) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(gram_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // a persistent grid: one block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = kNTiles * n_splits * batch;
  gram_kernel<kSplit><<<items < sms ? items : sms, kThreads, smem, stream>>>(tm, partial, batch, frames,
                                                                          split_frames, n_splits);
  return cudaGetLastError();
}

}  // namespace

// clean, denoised: (batch, t_len) float32; halves: (4, batch, 128 frames)
// bf16 scratch, frames = ceil(t_len / 128); partial: (batch, n_splits, 10,
// 2, 2, 128) float32 scratch; r_auto, r_cross: (batch, 512); split: 4, 3 or 1
// (the JAX split modes x4, x3, x1); the frames in ranges of split_frames
// (a multiple of the split's stage, 32 frames for x4 / x3, 64 for x1),
// n_splits of them, the last one non-empty.
extern "C" int fsem_correlation_lags_gram(const float* clean, const float* denoised, void* halves,
                                          float* partial, float* r_auto, float* r_cross, int batch,
                                          long long t_len, int split, int split_frames, int n_splits,
                                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long frames = (t_len + kHB - 1) / kHB;
  if (batch <= 0 || batch > 65535 || t_len <= 0 || frames > (1 << 30) || split_frames <= 0 || n_splits <= 0 ||
      (long long)(n_splits - 1) * split_frames >= frames || (long long)n_splits * split_frames < frames ||
      (long long)kNTiles * n_splits * batch > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (split != 4 && split != 3 && split != 1) return (int)cudaErrorInvalidValue;
  const long long row_len = frames * kHB;
  cudaError_t err = halves::split(clean, denoised, halves, t_len, row_len, batch, split != 1, stream);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm;
  const cuuint64_t dims[3] = {(cuuint64_t)kHB, (cuuint64_t)frames, (cuuint64_t)4 * batch};
  const cuuint64_t strides[2] = {(cuuint64_t)kHB * 2, (cuuint64_t)row_len * 2};
  const int box_rows = split == 1 ? Cfg<1>::kRows : Cfg<3>::kRows;
  if (!tensor_map(&tm, halves, 3, dims, strides, box_rows)) return (int)cudaErrorInvalidValue;
  switch (split) {
    case 4: err = launch_gram<4>(tm, partial, batch, (int)frames, split_frames, n_splits, stream); break;
    case 3: err = launch_gram<3>(tm, partial, batch, (int)frames, split_frames, n_splits, stream); break;
    default: err = launch_gram<1>(tm, partial, batch, (int)frames, split_frames, n_splits, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  gram_finalize_kernel<<<batch, 256, 0, stream>>>(partial, r_auto, r_cross, n_splits);
  return (int)cudaGetLastError();
}

// The split pass alone (sdr_halves.cuh), for the card tests: out (4,
// batch, row_len) bf16; lo 0 leaves the lo planes unwritten.
extern "C" int fsem_split_halves(const float* clean, const float* denoised, void* out, int batch, long long t_len,
                                 long long row_len, int lo, void* stream_ptr) {
  return (int)halves::split(clean, denoised, out, t_len, row_len, batch, lo != 0,
                            static_cast<cudaStream_t>(stream_ptr));
}
