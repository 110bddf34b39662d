// A14 "dotreduce" (the JAX package's
// ops/levinson_pallas.py::_levinson_kernel_dotreduce): A5's phased warp
// step with both dot products in one split butterfly and bn[k+1] from a
// rotating register; see levinson.cu.
#include "levinson.cuh"

namespace {

// A14 "dotreduce", phase A: bn_raw is b at this phase's indices (loaded a
// phase ahead), lane l's bn[base + ((l + 16) & 31)] with base = 1 for the
// first phase (step 0 needs bn[1]) and 32 (A - 1) after; rotated left one
// lane a step, lane 16 holds bn[k+1]
template <int A, int P>
__device__ __forceinline__ void dotreduce_phases(const float (&r1)[P], float (&u)[P], float (&v)[P], float (&y)[P],
                                                 float& se, float& recip, float& mu, const float* br, float safe0,
                                                 float bn_raw, int lane) {
  float bnc = __fdiv_rn(bn_raw, safe0);
  float bn_next_raw = 0.f;
  if constexpr (A < P) bn_next_raw = br[32 * A + ((lane + 16) & 31)];
  const int src = (lane + 1) & 31;
#pragma unroll 1
  for (int k = A == 1 ? 0 : 32 * (A - 1) - 1; k < 32 * A - 1; ++k) {
    warp_step<A, P, true>(r1, u, v, y, se, recip, mu, bnc, lane);
    bnc = __shfl_sync(fsem::kFullMask, bnc, src);
  }
  if constexpr (A < P) dotreduce_phases<A + 1, P>(r1, u, v, y, se, recip, mu, br, safe0, bn_next_raw, lane);
}

template <int P>
__global__ void __launch_bounds__(32) levinson_dotreduce_warp_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out) {
  constexpr int n = 32 * P;
  const int lane = threadIdx.x, row = blockIdx.x;
  const float* rr = r0 + (size_t)row * n;
  const float* br = b + (size_t)row * n;
  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  const int j1 = 1 + ((lane + 16) & 31);  // the first phase's bn indices
  const float bn_raw = j1 < n ? br[j1] : 0.f;
  float r1[P], u[P], v[P], y[P];
  load_system<P>(rr, br, safe0, lane, r1, u, v, y, nullptr);
  float se = __fmul_rn(r1[0], v[0]), recip = 1.f, mu = 0.f;
  dotreduce_phases<1, P>(r1, u, v, y, se, recip, mu, br, safe0, bn_raw, lane);
  finish_pipelined<P>(y, u, recip, mu, x_out + (size_t)row * n, lane);
}

struct DotreduceLaunch {
  template <int P>
  static void run(const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
    levinson_dotreduce_warp_kernel<P><<<batch, 32, 0, stream>>>(r0, b, x);
  }
};

}  // namespace

bool fsem::levinson_dotreduce(int n, const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
  return at_order<DotreduceLaunch>(n, r0, b, x, batch, stream);
}
