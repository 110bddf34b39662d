// Log-spectral distance of clean/denoised pairs, fused.
//
// Replaces four Pallas TPU kernels of the JAX package's ops/lsd_fused.py:
//   A1 _lsd_wholesig_raw_kernel: hop-aligned raw pairs, projection scale
//      computed in the kernel (lsd_scores(..., denoised_scale="auto")),
//   A2 _lsd_wholesig_kernel: pre-scaled pairs of any length, F + 1 <= 1024,
//   A3 _lsd_framed_kernel: the same function, frame-blocked, F + 1 > 1024,
//   A13 _lsd_wholesig_ct_kernel: A1's function with the chunk DFT factorized
//      (lsd_scores(..., dft_impl="ct")); see lsd_ct_kernel below.
// A2 and A3 compute one function and differ on the TPU only in how a row's
// chunks fit VMEM; here both are the frame-tile kernel without its scale
// stage (entry point fsem_lsd_wholesig), and A1 is it with the scale stage
// (fsem_lsd_wholesig_raw).
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
// hop-aligned), so each chunk is staged with a bound of T and transformed
// once. The Hann window is the exact 3-tap convolution
// Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]) in frequency, with
// X[-1] = conj X[1] and X[257] = conj X[255]; the Nyquist bin X[256] is the
// real alternating-sign sum of the frame's two chunks.
//
// What bounds it on this card: the function itself is bound by bytes. The
// signals are read once (131 MB at 64 x 16 s, 0.04 ms at 3.35 TB/s); a
// 512-point real FFT per frame and signal would need about 1.8 GFLOP in all
// (0.03 ms of float32 FMA at 67 TFLOP/s). This design's direct chunk DFT
// does 2 x 256 x 512 multiply-adds per chunk and signal (about 33.5 GFLOP,
// 0.5 ms), so its operations set its own floor; an FFT-structured chunk
// transform is the way below that.
//
// Design: up to three launches. (1) A1 only: sixteen blocks per row sum
// c*d and d*d over a slice each (no float atomics). (2) One block per (row,
// tile of TF frames) — the TPU's frame-block grid of A3, which on this card
// serves every length — adds its row's sixteen partials in a fixed order
// into the scale (A1), stages the tile's TF + 1 chunks of both signals in
// shared memory (the denoised chunks already scaled), takes their chunk
// DFTs with thread k owning bin k (the packed cos|sin table streams from
// L2: it is 512 KB and does not fit in shared memory), combines chunk pairs
// into frame spectra in shared memory, then one warp per frame applies the
// Hann taps and the log ratio and sums the frame's 257 bins. The block
// writes the sum of its frames' square roots. (3) One warp per row adds its
// tiles' partials in a fixed order and divides by F.
#include "common.cuh"

namespace {

constexpr int kHop = 256;              // n_fft / 2; one thread per DFT bin
constexpr int kBins = kHop;            // packed table bins 0..kHop-1
constexpr int kTileFrames = 16;        // frames per block
constexpr int kTileChunks = kTileFrames + 1;
constexpr int kThreads = kHop;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kBins + 1;        // frame spectrum row: bins 0..256
// phase 1: chunks[2][kTileChunks][kHop]; phase 2: re/im[2][kTileFrames][kRow]
constexpr int kChunkFloats = 2 * kTileChunks * kHop;
constexpr int kSpecFloats = 2 * 2 * kTileFrames * kRow;
constexpr int kSmemFloats = kChunkFloats > kSpecFloats ? kChunkFloats : kSpecFloats;
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

// kScale: apply the projection scale from scale_partial (A1); without it
// the denoised signal is used as given (A2/A3).
template <bool kScale>
__global__ void __launch_bounds__(kThreads) lsd_frames_kernel(
    const float* __restrict__ c, const float* __restrict__ d,
    const float* __restrict__ scale_partial, const float* __restrict__ table,
    float* __restrict__ partial, long long t_len, int n_frames, int n_tiles,
    float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float nyq[2][kTileChunks];
  __shared__ float red[kWarps];
  __shared__ float s_scale;

  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f0 = tile * kTileFrames;  // first frame of the tile
  const int g0 = f0 - 1;              // chunk index of local chunk 0
  if (kScale && tid == 0) {  // the row's projection scale, partials in order
    float num = 0.f, den = 0.f;
    for (int i = 0; i < kScaleSplits; ++i) {
      num += scale_partial[((size_t)b * kScaleSplits + i) * 2];
      den += scale_partial[((size_t)b * kScaleSplits + i) * 2 + 1];
    }
    s_scale = num / (den + eps);
  }
  __syncthreads();
  const float sc = kScale ? s_scale : 1.f;

  // stage chunks g0 .. g0 + kTileFrames of both signals; samples before 0
  // and from T on are the zero padding of the centered STFT
  float* chunks = smem;
  for (int i = tid; i < kChunkFloats; i += kThreads) {
    const int s = i / (kTileChunks * kHop);
    const int r = (i / kHop) % kTileChunks;
    const int n = i % kHop;
    const long long idx = (long long)(g0 + r) * kHop + n;
    float v = 0.f;
    if (idx >= 0 && idx < t_len) {
      const size_t off = (size_t)b * t_len + idx;
      v = s == 0 ? c[off] : (kScale ? d[off] * sc : d[off]);
    }
    chunks[i] = v;
  }
  __syncthreads();

  // chunk Nyquist bins: alternating-sign sums, one warp per chunk
  for (int row = warp; row < 2 * kTileChunks; row += kWarps) {
    const float* x = chunks + row * kHop;
    float a = 0.f;
    for (int n = lane; n < kHop; n += 32) a += (n & 1) ? -x[n] : x[n];
    a = fsem::warp_sum(a);
    if (lane == 0) nyq[row / kTileChunks][row % kTileChunks] = a;
  }

  // chunk DFTs: thread tid owns bin tid, both the cos and the sin column
  float acc_re[2][kTileChunks], acc_im[2][kTileChunks];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < kTileChunks; ++r) {
      acc_re[s][r] = 0.f;
      acc_im[s][r] = 0.f;
    }
  for (int n = 0; n < kHop; n += 4) {
    float wc[4], ws[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wc[j] = __ldg(table + (size_t)(n + j) * (2 * kBins) + tid);
      ws[j] = __ldg(table + (size_t)(n + j) * (2 * kBins) + kBins + tid);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < kTileChunks; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(chunks + (s * kTileChunks + r) * kHop + n);
        float ar = acc_re[s][r], ai = acc_im[s][r];
        ar = fmaf(x.x, wc[0], ar);
        ai = fmaf(x.x, ws[0], ai);
        ar = fmaf(x.y, wc[1], ar);
        ai = fmaf(x.y, ws[1], ai);
        ar = fmaf(x.z, wc[2], ar);
        ai = fmaf(x.z, ws[2], ai);
        ar = fmaf(x.w, wc[3], ar);
        ai = fmaf(x.w, ws[3], ai);
        acc_re[s][r] = ar;
        acc_im[s][r] = ai;
      }
  }
  __syncthreads();  // every thread is done with the chunks: reuse the space

  // frame spectra X_f[k] = A_{f-1}[k] + (-1)^k A_f[k] (local chunks f, f+1)
  float* spec_re = smem;
  float* spec_im = smem + 2 * kTileFrames * kRow;
  const float sgn = (tid & 1) ? -1.f : 1.f;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) {
      spec_re[(s * kTileFrames + f) * kRow + tid] = acc_re[s][f] + sgn * acc_re[s][f + 1];
      spec_im[(s * kTileFrames + f) * kRow + tid] = acc_im[s][f] + sgn * acc_im[s][f + 1];
    }
  if (tid < 2 * kTileFrames) {  // Nyquist bin: (-1)^256 = +1, imaginary part 0
    const int s = tid / kTileFrames, f = tid % kTileFrames;
    spec_re[(s * kTileFrames + f) * kRow + kBins] = nyq[s][f] + nyq[s][f + 1];
    spec_im[(s * kTileFrames + f) * kRow + kBins] = 0.f;
  }
  __syncthreads();

  // per frame: mean over bins of the squared log ratio, then its sqrt
  float total = 0.f;
  for (int f = warp; f < kTileFrames && f0 + f < n_frames; f += kWarps) {
    const float* cre = spec_re + f * kRow;
    const float* cim = spec_im + f * kRow;
    const float* dre = spec_re + (kTileFrames + f) * kRow;
    const float* dim = spec_im + (kTileFrames + f) * kRow;
    float acc = 0.f;
    for (int k = lane; k <= kBins; k += 32) {
      const float pc = hann_power(cre, cim, k);
      const float pd = hann_power(dre, dim, k);
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
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    partial[(size_t)b * n_tiles + tile] = s;
  }
}

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

// Sets the frame kernel's shared-memory limit and launches it, then the
// finalize kernel. scale_partial is read only when kScale.
template <bool kScale>
int launch_frames(const float* clean, const float* denoised, const float* table,
                  const float* scale_partial, float* partial, float* out,
                  int batch, long long t_len, float eps, cudaStream_t stream) {
  const int n_frames = (int)(t_len / kHop) + 1;
  const int n_tiles = (n_frames + kTileFrames - 1) / kTileFrames;
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lsd_frames_kernel<kScale>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lsd_frames_kernel<kScale><<<dim3(n_tiles, batch), kThreads, smem, stream>>>(
      clean, denoised, scale_partial, table, partial, t_len, n_frames, n_tiles, eps);
  lsd_finalize_kernel<<<batch, 32, 0, stream>>>(partial, out, n_tiles, n_frames);
  return (int)cudaGetLastError();
}

}  // namespace

// A1. clean, denoised: (batch, nc * 256) float32; table: (256, 512) packed
// cos|sin chunk-DFT matrix; scale_partial: (batch, 16, 2) scratch; partial:
// (batch, ceil((nc + 1) / 16)) scratch; out: (batch,) LSD scores.
extern "C" int fsem_lsd_wholesig_raw(const float* clean, const float* denoised,
                                     const float* table, float* scale_partial,
                                     float* partial, float* out, int batch,
                                     int nc, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long t_len = (long long)nc * kHop;
  lsd_scale_kernel<<<dim3(kScaleSplits, batch), 256, 0, stream>>>(
      clean, denoised, scale_partial, t_len);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_frames<true>(clean, denoised, table, scale_partial, partial, out,
                             batch, t_len, eps, stream);
}

// A2/A3. clean, denoised (pre-scaled): (batch, t_len) float32, any t_len;
// table as above; partial: (batch, ceil((t_len / 256 + 1) / 16)) scratch;
// out: (batch,) LSD scores.
extern "C" int fsem_lsd_wholesig(const float* clean, const float* denoised,
                                 const float* table, float* partial, float* out,
                                 int batch, long long t_len, float eps,
                                 void* stream_ptr) {
  return launch_frames<false>(clean, denoised, table, nullptr, partial, out, batch,
                              t_len, eps, static_cast<cudaStream_t>(stream_ptr));
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
