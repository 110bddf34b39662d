// STOI / ESTOI segment correlations from third-octave band envelopes.
//
// Replaces: ops/stoi_fused.py::_stoi_kernel of the JAX package (Pallas,
// TPU), the kernel behind stoi_segment_sums.
//
// What it computes, per row, for every 30-frame segment m < num_segments
// and band j (X, Y: clean and denoised envelopes over the segment):
//   loop A: sums and sums of squares; mu_x, mu_y,
//           consts = ||X|| / (||Y|| + 1e-9)
//   loop B: centered variances vx, vy; Y' = min(consts Y, (1 + 10^(15/20)) X);
//           num = sum (X - mu_x) Y'
//   loop C: centered variance of Y'; per frame the band-normalized ESTOI
//           correlation of x1 = (X - mu_x)/sqrt(vx), y1 = (Y - mu_y)/sqrt(vy)
//   stoi_m = sum_j num / sqrt(vx var(Y')), estoi_m = sum over frames
// with every rsqrt floored at 1e-30, and returns the sums over segments.
// Variances are centered (a second pass after the mean), as in the TPU
// kernel: the expanded sum-of-squares form loses precision on
// near-constant segments.
//
// What bounds it on this card: the issue rate of its float32 operations
// (about 12 k a segment, 1 GFLOP at 64 x 16 s; the envelopes are 9.6 MB).
// ESTOI's band sums are the larger part, five sums over the 15 bands for
// each of a segment's 30 frames: as half-warp shuffle butterflies (the
// kernel before this one) they cost four times the arithmetic they add.
//
// Design: one block of 128 threads per (row, tile of 64 segments); the
// tile's 93 frames of both envelopes are staged in shared memory, bands
// major (an odd frame stride: staging's writes spread over the banks, and
// a warp's 32 consecutive segments read consecutive words). Two stages,
// two threads per segment in each, no shuffles in either:
// * stage 1, per (segment, band): loops A and B and var(Y') on the
//   segment's 30 frames held in registers; mu_x, mu_y, rsx, rsy go to
//   shared memory (one float4 per (band, segment)); each thread adds its
//   bands' STOI terms in band order (bands 0-7, 8-14);
// * stage 2, per (segment, frame): x1, y1 and the five band sums serially
//   over the 15 bands in registers, from the staged envelopes and the
//   segment's statistics (loaded once); each thread adds its 15 frames'
//   ESTOI terms in order.
// A segment's two halves are added in order, the tile's valid segments by
// a warp butterfly and the warps in order; a tile whose first segment is
// past the row's last valid one writes zeros and exits. The block writes
// its (stoi, estoi) partial sums; a second launch adds the tiles per row
// in a fixed order: deterministic, no atomics. (Folding that launch into
// the first, the last block of a row found by an integer counter adding
// the tiles in the same order, measured slower: a memset and atomics.)
#include "common.cuh"

namespace {

constexpr int kN = 30;         // frames per segment
constexpr int kBands = 15;
constexpr int kTileSegs = 64;
constexpr int kThreads = 2 * kTileSegs;  // two threads per segment
constexpr int kWarps = kThreads / 32;
constexpr int kTileFrames = kTileSegs + kN - 1;
constexpr int kStride = kTileFrames;  // odd: staging's writes spread over the banks
constexpr int kHalfBands = 8;         // stage 1: bands 0-7 and 8-14
constexpr int kHalfFrames = kN / 2;   // stage 2: frames 0-14 and 15-29
constexpr float kClip = 6.6234132519034908f;  // 1 + 10^(15/20)

static_assert(kStride % 2 == 1 && kTileSegs % 32 == 0, "layout");

__global__ void __launch_bounds__(kThreads) stoi_segments_kernel(
    const float* __restrict__ tob_c, const float* __restrict__ tob_d,
    const int* __restrict__ num_segments, float* __restrict__ partial,
    int f_len, int n_tiles) {
  __shared__ float xs[kBands * kStride];
  __shared__ float ys[kBands * kStride];
  __shared__ float4 stats[kBands][kTileSegs];  // (mu_x, mu_y, rsx, rsy)
  __shared__ float seg_sum[2][2][kTileSegs];   // [stoi, estoi][half][segment]
  __shared__ float red[2][kWarps];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int m0 = tile * kTileSegs;
  const int n_valid = min(num_segments[b], f_len - kN + 1);
  float* tile_out = partial + ((size_t)b * n_tiles + tile) * 2;
  if (m0 >= n_valid) {  // no valid segment in this tile
    if (tid == 0) {
      tile_out[0] = 0.f;
      tile_out[1] = 0.f;
    }
    return;
  }

  const float* cb = tob_c + ((size_t)b * f_len + m0) * kBands;
  const float* db = tob_d + ((size_t)b * f_len + m0) * kBands;
  const int staged = min(kTileFrames, f_len - m0) * kBands;
  for (int i = tid; i < kTileFrames * kBands; i += kThreads) {
    const int fr = i / kBands, j = i - fr * kBands;
    const bool ok = i < staged;
    xs[j * kStride + fr] = ok ? cb[i] : 0.f;
    ys[j * kStride + fr] = ok ? db[i] : 0.f;
  }
  __syncthreads();

  const int m = tid % kTileSegs, half = tid / kTileSegs;
  const bool valid = m0 + m < n_valid;

  // stage 1: per (segment, band) statistics and STOI terms
  float stoi_part = 0.f;
  if (valid) {
    const int j_end = min(half * kHalfBands + kHalfBands, kBands);
    for (int j = half * kHalfBands; j < j_end; ++j) {
      const float* xw = xs + j * kStride + m;
      const float* yw = ys + j * kStride + m;
      float xv[kN], yv[kN], yp[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        xv[n] = xw[n];
        yv[n] = yw[n];
      }
      float sc = 0.f, sc2 = 0.f, sd = 0.f, sd2 = 0.f;  // loop A
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sc += xv[n];
        sc2 += xv[n] * xv[n];
        sd += yv[n];
        sd2 += yv[n] * yv[n];
      }
      const float mu_x = sc * (1.f / kN), mu_y = sd * (1.f / kN);
      const float consts = sqrtf(sc2) / (sqrtf(sd2) + 1e-9f);
      float vx = 0.f, vy = 0.f, syp = 0.f, num = 0.f;  // loop B
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float xc = xv[n] - mu_x, yc = yv[n] - mu_y;
        vx += xc * xc;
        vy += yc * yc;
        yp[n] = fminf(consts * yv[n], kClip * xv[n]);
        syp += yp[n];
        num += xc * yp[n];
      }
      const float mu_yp = syp * (1.f / kN);
      float vyp = 0.f;  // loop C's variance of Y'
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float ypc = yp[n] - mu_yp;
        vyp += ypc * ypc;
      }
      const float rsx = rsqrtf(fmaxf(vx, 1e-30f));
      const float rsy = rsqrtf(fmaxf(vy, 1e-30f));
      const float rsyp = rsqrtf(fmaxf(vyp, 1e-30f));
      stats[j][m] = make_float4(mu_x, mu_y, rsx, rsy);
      stoi_part += num * rsx * rsyp;
    }
  }
  seg_sum[0][half][m] = stoi_part;
  __syncthreads();

  // stage 2: per (segment, frame) ESTOI band sums, serially over the bands
  float estoi_part = 0.f;
  if (valid) {
    float4 st[kBands];
#pragma unroll
    for (int j = 0; j < kBands; ++j) st[j] = stats[j][m];
    const int f0 = m + half * kHalfFrames;
    for (int f = 0; f < kHalfFrames; ++f) {
      float p = 0.f, mx = 0.f, my = 0.f, qx = 0.f, qy = 0.f;
#pragma unroll
      for (int j = 0; j < kBands; ++j) {
        const float x1 = (xs[j * kStride + f0 + f] - st[j].x) * st[j].z;
        const float y1 = (ys[j * kStride + f0 + f] - st[j].y) * st[j].w;
        p += x1 * y1;
        mx += x1;
        my += y1;
        qx += x1 * x1;
        qy += y1 * y1;
      }
      const float numer = p - mx * my * (1.f / kBands);
      const float s2x = rsqrtf(fmaxf(qx - mx * mx * (1.f / kBands), 1e-30f));
      const float s2y = rsqrtf(fmaxf(qy - my * my * (1.f / kBands), 1e-30f));
      estoi_part += numer * s2x * s2y;
    }
  }
  seg_sum[1][half][m] = estoi_part;
  __syncthreads();

  // the tile's valid segments: each segment's halves in order, a butterfly
  // over each warp of the first kTileSegs threads, then the warps in order
  if (tid < kTileSegs) {
    float s = 0.f, e = 0.f;
    if (valid) {
      s = seg_sum[0][0][tid] + seg_sum[0][1][tid];
      e = seg_sum[1][0][tid] + seg_sum[1][1][tid];
    }
    s = fsem::warp_sum(s);
    e = fsem::warp_sum(e);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = s;
      red[1][tid >> 5] = e;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, e = 0.f;
    for (int w = 0; w < kTileSegs / 32; ++w) {
      s += red[0][w];
      e += red[1][w];
    }
    tile_out[0] = s;
    tile_out[1] = e;
  }
}

// the per-row sums of the tiles' partials, in tile order: lane l adds
// tiles l, l + 32, ..., then a butterfly (one warp per row)
__global__ void stoi_finalize_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int n_tiles) {
  const int b = blockIdx.x;
  float s = 0.f, e = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += 32) {
    s += partial[((size_t)b * n_tiles + i) * 2 + 0];
    e += partial[((size_t)b * n_tiles + i) * 2 + 1];
  }
  s = fsem::warp_sum(s);
  e = fsem::warp_sum(e);
  if (threadIdx.x == 0) {
    out[(size_t)b * 2 + 0] = s;
    out[(size_t)b * 2 + 1] = e;
  }
}

}  // namespace

// tob_c, tob_d: (batch, f_len, 15) float32; num_segments: (batch,) int32;
// partial: (batch, ceil((f_len - 29) / 64), 2) scratch; out: (batch, 2)
// (stoi sum, estoi sum).
extern "C" int fsem_stoi_segment_sums(const float* tob_c, const float* tob_d,
                                      const int* num_segments, float* partial,
                                      float* out, int batch, int f_len,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int positions = f_len - kN + 1;
  const int n_tiles = positions > 0 ? (positions + kTileSegs - 1) / kTileSegs : 0;
  if (n_tiles > 0)
    stoi_segments_kernel<<<dim3(n_tiles, batch), kThreads, 0, stream>>>(
        tob_c, tob_d, num_segments, partial, f_len, n_tiles);
  stoi_finalize_kernel<<<batch, 32, 0, stream>>>(partial, out, n_tiles);
  return (int)cudaGetLastError();
}
