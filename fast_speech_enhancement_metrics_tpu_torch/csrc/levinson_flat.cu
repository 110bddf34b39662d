// A14 "flat", "flat_u4", "flat_u8" (the JAX package's
// ops/levinson_pallas.py::_levinson_kernel_flat): A5's warp step at the
// full width from step 0, the step loop unrolled 1, 4 or 8 times; see
// levinson.cu.
#include "levinson.cuh"

namespace {

// A14 "flat", "flat_u4", "flat_u8": A5's step at the full width P from
// step 0 (both lane sums over all P registers), the loop unrolled U times
template <int P, int U>
__global__ void __launch_bounds__(32) levinson_flat_warp_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out) {
  constexpr int n = 32 * P;
  __shared__ float bn_s[n];
  const int lane = threadIdx.x, row = blockIdx.x;
  const float* rr = r0 + (size_t)row * n;
  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  float r1[P], u[P], v[P], y[P];
  load_system<P>(rr, b + (size_t)row * n, safe0, lane, r1, u, v, y, bn_s);
  __syncwarp();
  float pe[P];
#pragma unroll
  for (int i = 0; i < P; ++i) pe[i] = __fmul_rn(r1[i], v[i]);
  tree_sum<P, P>(pe);
  float se = pe[0], recip = 1.f, mu = 0.f;
  if constexpr (U == 1) {
    // the steps in A5's 32-step blocks, as nested loops: a single loop of
    // n - 1 steps spilled 40 bytes at n = 896 (ptxas), these none
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
#pragma unroll 1
      for (int k = p == 0 ? 0 : 32 * p - 1; k < 32 * p + 31; ++k)
        warp_step<P, P>(r1, u, v, y, se, recip, mu, bn_s[k + 1], lane);
    }
  } else {
#pragma unroll (U)
    for (int k = 0; k < n - 1; ++k) warp_step<P, P>(r1, u, v, y, se, recip, mu, bn_s[k + 1], lane);
  }
  finish_pipelined<P>(y, u, recip, mu, x_out + (size_t)row * n, lane);
}

struct FlatLaunch {
  template <int P>
  static void run(int unroll, const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
    if (unroll == 1) levinson_flat_warp_kernel<P, 1><<<batch, 32, 0, stream>>>(r0, b, x);
    if (unroll == 4) levinson_flat_warp_kernel<P, 4><<<batch, 32, 0, stream>>>(r0, b, x);
    if (unroll == 8) levinson_flat_warp_kernel<P, 8><<<batch, 32, 0, stream>>>(r0, b, x);
  }
};

}  // namespace

bool fsem::levinson_flat(int unroll, int n, const float* r0, const float* b, float* x, int batch,
                         cudaStream_t stream) {
  return (unroll == 1 || unroll == 4 || unroll == 8) && at_order<FlatLaunch>(n, unroll, r0, b, x, batch, stream);
}
