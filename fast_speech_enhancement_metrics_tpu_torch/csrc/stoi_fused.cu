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
// What bounds it on this card: operations, and few of them (about 12 k flops
// a segment, about 1 GFLOP at 64 x 16 s); the envelopes are 9.6 MB. The
// kernel is small next to the STOI front end around it.
//
// Design: one block per (row, tile of 128 segments). The tile's 157
// frames of both envelopes are staged in shared memory, bands padded to
// 16. A warp scores two segments at a time, one per 16-lane half, one lane
// per band; the three loops run over the segment's 30 frames in
// registers, and the ESTOI band sums are half-warp shuffle reductions.
// The block writes its (stoi, estoi) partial sums; a second launch adds
// the tiles per row in a fixed order: deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int kN = 30;         // frames per segment
constexpr int kBands = 15;
constexpr int kLanes = 16;     // bands padded to a half warp
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileSegs = 128;
constexpr int kTileFrames = kTileSegs + kN - 1;
constexpr float kClip = 6.6234132519034908f;  // 1 + 10^(15/20)

static_assert(kTileSegs % (2 * kWarps) == 0, "a pass scores two segments per warp");

__global__ void __launch_bounds__(kThreads) stoi_segments_kernel(
    const float* __restrict__ tob_c, const float* __restrict__ tob_d,
    const int* __restrict__ num_segments, float* __restrict__ partial,
    int f_len, int n_tiles) {
  __shared__ float xs[kTileFrames][kLanes];
  __shared__ float ys[kTileFrames][kLanes];
  __shared__ float red[2][kWarps];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int m0 = tile * kTileSegs;
  const float* cb = tob_c + (size_t)b * f_len * kBands;
  const float* db = tob_d + (size_t)b * f_len * kBands;
  for (int i = tid; i < kTileFrames * kLanes; i += kThreads) {
    const int fr = i / kLanes, j = i % kLanes, g = m0 + fr;
    const bool ok = j < kBands && g < f_len;
    xs[fr][j] = ok ? cb[(size_t)g * kBands + j] : 0.f;
    ys[fr][j] = ok ? db[(size_t)g * kBands + j] : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int j = lane & 15, half = lane >> 4;
  const int n_valid = min(num_segments[b], f_len - kN + 1);
  float stoi_acc = 0.f, estoi_acc = 0.f;
  for (int pass = 0; pass < kTileSegs / (2 * kWarps); ++pass) {
    const int ml = (pass * kWarps + warp) * 2 + half;  // segment within the tile
    const bool valid = m0 + ml < n_valid;

    float sc = 0.f, sc2 = 0.f, sd = 0.f, sd2 = 0.f;  // loop A
    for (int n = 0; n < kN; ++n) {
      const float xv = xs[ml + n][j], yv = ys[ml + n][j];
      sc += xv;
      sc2 += xv * xv;
      sd += yv;
      sd2 += yv * yv;
    }
    const float mu_x = sc * (1.f / kN), mu_y = sd * (1.f / kN);
    const float consts = sqrtf(sc2) / (sqrtf(sd2) + 1e-9f);

    float vx = 0.f, vy = 0.f, syp = 0.f, num = 0.f;  // loop B
    for (int n = 0; n < kN; ++n) {
      const float xv = xs[ml + n][j], yv = ys[ml + n][j];
      const float xc = xv - mu_x, yc = yv - mu_y;
      vx += xc * xc;
      vy += yc * yc;
      const float yp = fminf(consts * yv, kClip * xv);
      syp += yp;
      num += xc * yp;
    }
    const float mu_yp = syp * (1.f / kN);
    const float rsx = rsqrtf(fmaxf(vx, 1e-30f));
    const float rsy = rsqrtf(fmaxf(vy, 1e-30f));

    float vyp = 0.f, estoi = 0.f;  // loop C
    for (int n = 0; n < kN; ++n) {
      const float xv = xs[ml + n][j], yv = ys[ml + n][j];
      const float yp = fminf(consts * yv, kClip * xv);
      const float ypc = yp - mu_yp;
      vyp += ypc * ypc;
      const float x1 = j < kBands ? (xv - mu_x) * rsx : 0.f;
      const float y1 = j < kBands ? (yv - mu_y) * rsy : 0.f;
      const float p = fsem::half_warp_sum(x1 * y1);
      const float mx = fsem::half_warp_sum(x1);
      const float my = fsem::half_warp_sum(y1);
      const float qx = fsem::half_warp_sum(x1 * x1);
      const float qy = fsem::half_warp_sum(y1 * y1);
      const float numer = p - mx * my * (1.f / kBands);
      const float s2x = rsqrtf(fmaxf(qx - mx * mx * (1.f / kBands), 1e-30f));
      const float s2y = rsqrtf(fmaxf(qy - my * my * (1.f / kBands), 1e-30f));
      estoi += numer * s2x * s2y;
    }
    const float rsyp = rsqrtf(fmaxf(vyp, 1e-30f));
    const float stoi = fsem::half_warp_sum(j < kBands ? num * rsx * rsyp : 0.f);
    if (valid && j == 0) {
      stoi_acc += stoi;
      estoi_acc += estoi;
    }
  }
  stoi_acc = fsem::warp_sum(stoi_acc);
  estoi_acc = fsem::warp_sum(estoi_acc);
  if (lane == 0) {
    red[0][warp] = stoi_acc;
    red[1][warp] = estoi_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, e = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += red[0][w];
      e += red[1][w];
    }
    partial[((size_t)b * n_tiles + tile) * 2 + 0] = s;
    partial[((size_t)b * n_tiles + tile) * 2 + 1] = e;
  }
}

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
// partial: (batch, ceil((f_len - 29) / 128), 2) scratch; out: (batch, 2)
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
