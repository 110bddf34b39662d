// Auto- and cross-correlation of clean/denoised pairs at 512 lags.
//
// Replaces: ops/sdr_corr_gram.py::_gram_kernel of the JAX package (Pallas,
// TPU), the kernel behind correlation_lags_gram(..., split=) that SDR uses
// on one device, in its three split modes.
//
// What it computes, per pair (c, d) of T samples, for l = 0..511:
//   r_auto[l]  = sum_t c[t - l] * c[t]
//   r_cross[l] = sum_t c[t - l] * d[t]
// with zeros outside 0..T-1 (the zero-padded linear correlation).
//
// What bounds it on this card: the function itself is bound by bytes. The
// signals are read once (131 MB, 0.04 ms at 3.35 TB/s); an overlap-save FFT
// correlation needs about 2 GFLOP (0.03 ms of float32 FMA at 67 TFLOP/s).
// This direct design does 2 x 512 multiply-adds per sample and pair (about
// 33.5 GFLOP at 64 x 16 s, 0.5 ms), so its operations set its own floor; a
// transform-domain kernel is the way below that. Split x3 does three times
// those multiply-adds (1.5 ms), x1 the same count; both add the splits.
//
// Design: a direct time-domain product, no transform. One block per (row,
// slab of kSlab samples of t). The block stages c over the slab and the 512
// samples before it, and d over the slab, in shared memory. Thread (g, q)
// owns lags 8g .. 8g+7 over a quarter q of the slab and walks it 8 samples
// at a time: 16 window samples of c and 8 + 8 samples of c and d feed
// 8 x 8 x 2 register FMAs, so each shared-memory load feeds 4 FMAs. The
// four quarters are added in a fixed order, the block writes its slab's
// 2 x 512 partial sums, and a second launch adds the slabs per row in a
// fixed order: deterministic, no atomics.
//
// Split modes (the template parameter kSplit). The TPU kernel forms every
// product from bf16 halves, hi = bf16(x) and lo = bf16(x - hi), on its
// matrix unit: x4 sums hh + hl + lh + ll, x3 drops ll, x1 keeps hh. Here
// kSplit = 4 is the plain float32 product (the float32 class that x4
// reaches on the TPU); kSplit = 3 and 1 form the products from the halves
// of the lagged window (c) and of the target (c or d) in registers, each
// half product exact in float32. On this card the halves save nothing: they
// exist so that "gram" and "gram_x1" give the reference's results.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kLags = 512;
constexpr int kLagsPerThread = 8;
constexpr int kGroups = kLags / kLagsPerThread;  // 64 lag groups
constexpr int kQuarters = 4;
constexpr int kThreads = kGroups * kQuarters;   // 256
constexpr int kSlab = 4096;                     // samples of t per block
constexpr int kQuarter = kSlab / kQuarters;
constexpr int kStep = 8;                        // samples of t per inner step

static_assert(kQuarters * 2 * kLags <= kSlab + kLags, "reduction reuses the c tile");

__device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16(x)); }

template <int kSplit>
__global__ void __launch_bounds__(kThreads) corr_slab_kernel(
    const float* __restrict__ c, const float* __restrict__ d,
    float* __restrict__ partial, int t_len, int n_slabs) {
  // cs[i] = c[t0 - kLags + i]; ds[i] = d[t0 + i]
  __shared__ __align__(16) float cs[kSlab + kLags];
  __shared__ __align__(16) float ds[kSlab];
  const int b = blockIdx.y, slab = blockIdx.x, tid = threadIdx.x;
  const long long t0 = (long long)slab * kSlab;
  const float* cr = c + (size_t)b * t_len;
  const float* dr = d + (size_t)b * t_len;
  for (int i = tid; i < kSlab + kLags; i += kThreads) {
    const long long t = t0 - kLags + i;
    cs[i] = (t >= 0 && t < t_len) ? cr[t] : 0.f;
  }
  for (int i = tid; i < kSlab; i += kThreads) {
    const long long t = t0 + i;
    ds[i] = t < t_len ? dr[t] : 0.f;
  }
  __syncthreads();

  const int g = tid % kGroups, q = tid / kGroups;
  float acc_c[kLagsPerThread], acc_d[kLagsPerThread];
#pragma unroll
  for (int j = 0; j < kLagsPerThread; ++j) {
    acc_c[j] = 0.f;
    acc_d[j] = 0.f;
  }
  for (int tt = q * kQuarter; tt < (q + 1) * kQuarter; tt += kStep) {
    // lag l = 8g + j at time t = t0 + tt + i reads c[t0 + tt + i - 8g - j]:
    // window w[m] = c[t0 + tt - 8g - 8 + m], m = i - j + 8 in 1..15
    const float4* wp = reinterpret_cast<const float4*>(cs + tt + kLags - kLagsPerThread * g - kLagsPerThread);
    const float4* yp = reinterpret_cast<const float4*>(cs + tt + kLags);
    const float4* dp = reinterpret_cast<const float4*>(ds + tt);
    float w[16], yc[kStep], yd[kStep];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 a = wp[v];
      w[4 * v] = a.x;
      w[4 * v + 1] = a.y;
      w[4 * v + 2] = a.z;
      w[4 * v + 3] = a.w;
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float4 a = yp[v], e = dp[v];
      yc[4 * v] = a.x;
      yc[4 * v + 1] = a.y;
      yc[4 * v + 2] = a.z;
      yc[4 * v + 3] = a.w;
      yd[4 * v] = e.x;
      yd[4 * v + 1] = e.y;
      yd[4 * v + 2] = e.z;
      yd[4 * v + 3] = e.w;
    }
    if constexpr (kSplit == 4) {
#pragma unroll
      for (int i = 0; i < kStep; ++i)
#pragma unroll
        for (int j = 0; j < kLagsPerThread; ++j) {
          const float cv = w[i - j + kLagsPerThread];
          acc_c[j] = fmaf(cv, yc[i], acc_c[j]);
          acc_d[j] = fmaf(cv, yd[i], acc_d[j]);
        }
    } else {
      // halves in place: w, yc, yd become the hi parts, wl, cl, dl the lo
      float wl[16], cl[kStep], dl[kStep];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const float h = bf16_hi(w[m]);
        wl[m] = bf16_hi(w[m] - h);
        w[m] = h;
      }
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const float hc = bf16_hi(yc[i]), hd = bf16_hi(yd[i]);
        cl[i] = bf16_hi(yc[i] - hc);
        dl[i] = bf16_hi(yd[i] - hd);
        yc[i] = hc;
        yd[i] = hd;
      }
#pragma unroll
      for (int i = 0; i < kStep; ++i)
#pragma unroll
        for (int j = 0; j < kLagsPerThread; ++j) {
          const float ch = w[i - j + kLagsPerThread];
          acc_c[j] = fmaf(ch, yc[i], acc_c[j]);
          acc_d[j] = fmaf(ch, yd[i], acc_d[j]);
          if constexpr (kSplit == 3) {
            const float clo = wl[i - j + kLagsPerThread];
            acc_c[j] = fmaf(ch, cl[i], acc_c[j]);
            acc_c[j] = fmaf(clo, yc[i], acc_c[j]);
            acc_d[j] = fmaf(ch, dl[i], acc_d[j]);
            acc_d[j] = fmaf(clo, yd[i], acc_d[j]);
          }
        }
    }
  }
  __syncthreads();  // every thread is done with cs: reuse it for the sums

  float* red = cs;  // red[q][corr][lag]
#pragma unroll
  for (int j = 0; j < kLagsPerThread; ++j) {
    red[(q * 2 + 0) * kLags + kLagsPerThread * g + j] = acc_c[j];
    red[(q * 2 + 1) * kLags + kLagsPerThread * g + j] = acc_d[j];
  }
  __syncthreads();
  float* out = partial + ((size_t)b * n_slabs + slab) * (2 * kLags);
  for (int o = tid; o < 2 * kLags; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int qq = 0; qq < kQuarters; ++qq) s += red[qq * 2 * kLags + o];
    out[o] = s;
  }
}

__global__ void corr_finalize_kernel(const float* __restrict__ partial,
                                     float* __restrict__ r_auto,
                                     float* __restrict__ r_cross, int n_slabs) {
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < 2 * kLags; o += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_slabs; ++k) s += partial[((size_t)b * n_slabs + k) * (2 * kLags) + o];
    if (o < kLags)
      r_auto[(size_t)b * kLags + o] = s;
    else
      r_cross[(size_t)b * kLags + o - kLags] = s;
  }
}

}  // namespace

// clean, denoised: (batch, t_len) float32; partial: (batch, ceil(t_len /
// 4096), 2, 512) scratch; r_auto, r_cross: (batch, 512); split: 4, 3 or 1
// (the JAX split modes x4, x3, x1).
extern "C" int fsem_correlation_lags_gram(const float* clean, const float* denoised,
                                          float* partial, float* r_auto,
                                          float* r_cross, int batch, int t_len,
                                          int split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_slabs = (t_len + kSlab - 1) / kSlab;
  const dim3 grid(n_slabs, batch);
  switch (split) {
    case 4: corr_slab_kernel<4><<<grid, kThreads, 0, stream>>>(clean, denoised, partial, t_len, n_slabs); break;
    case 3: corr_slab_kernel<3><<<grid, kThreads, 0, stream>>>(clean, denoised, partial, t_len, n_slabs); break;
    case 1: corr_slab_kernel<1><<<grid, kThreads, 0, stream>>>(clean, denoised, partial, t_len, n_slabs); break;
    default: return (int)cudaErrorInvalidValue;
  }
  corr_finalize_kernel<<<batch, 256, 0, stream>>>(partial, r_auto, r_cross, n_slabs);
  return (int)cudaGetLastError();
}
