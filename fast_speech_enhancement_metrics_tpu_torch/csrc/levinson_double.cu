// A14 "double" (the JAX package's
// ops/levinson_pallas.py::_levinson_kernel_double): two steps a round
// from five reductions of the current state, phased; see levinson.cu.
#include "levinson.cuh"

namespace {

// A14 "double": the round of steps k and k + 1 on registers 0 .. A - 1
// (A = (k + 2) / 32 + 1), from the state u, v, y before step k; every
// operation the reference's, in its order
template <int A, int P>
__device__ __forceinline__ void double_round(const float (&r1)[P], const float (&r2)[P], float (&u)[P],
                                             float (&v)[P], float (&y)[P], float bn1, float bn2, int lane) {
  float a0[A], a1[A], a2[A], a3[A], a4[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    a0[i] = __fmul_rn(r1[i], v[i]);
    a1[i] = __fmul_rn(r2[i], v[i]);
    a2[i] = __fmul_rn(r1[i], u[i]);
    a3[i] = __fmul_rn(r1[i], y[i]);
    a4[i] = __fmul_rn(r2[i], y[i]);
  }
  tree_sum<A, A>(a0);
  tree_sum<A, A>(a1);
  tree_sum<A, A>(a2);
  tree_sum<A, A>(a3);
  tree_sum<A, A>(a4);
  float s[5] = {a0[0], a1[0], a2[0], a3[0], a4[0]};
  butterflies<5>(s);
  const float ef1 = s[0], p = s[1], uu = s[2];
  const float mu1 = __fsub_rn(bn1, s[3]), q2 = __fsub_rn(bn2, s[4]);
  const float rho1 = fsem::rcp_rn(guard(__fsub_rn(1.f, __fmul_rn(ef1, ef1))));
  const float ef2 = __fmul_rn(rho1, __fsub_rn(p, __fmul_rn(ef1, uu)));
  const float mu2 = __fsub_rn(q2, __fmul_rn(__fmul_rn(mu1, rho1), __fsub_rn(uu, __fmul_rn(ef1, p))));
  // the shifts of the round's entry state and what rho2 does not touch, in
  // place from the top register down (register i's shifts read the entry
  // values of registers i and i - 1): u <- u1 - ef2 g2, v <- g2 - ef2 u1,
  // y <- S^2(y) + mu1 S(u1), with u1 = (u - ef1 S(v)) rho1, g2 = S(v1) =
  // rho1 (S^2(v) - ef1 S(u)), S(u1) = rho1 (S(u) - ef1 S^2(v))
#pragma unroll
  for (int i = A - 1; i >= 0; --i) {
    const int prev = i > 0 ? i - 1 : 0;
    const float sv = shift_right<1>(v[i], v[prev], i == 0, lane);
    const float ssv = shift_right<2>(v[i], v[prev], i == 0, lane);
    const float su = shift_right<1>(u[i], u[prev], i == 0, lane);
    const float ssy = shift_right<2>(y[i], y[prev], i == 0, lane);
    const float u1 = __fmul_rn(__fsub_rn(u[i], __fmul_rn(ef1, sv)), rho1);
    const float g2 = __fmul_rn(rho1, __fsub_rn(ssv, __fmul_rn(ef1, su)));
    const float su1 = __fmul_rn(rho1, __fsub_rn(su, __fmul_rn(ef1, ssv)));
    y[i] = __fadd_rn(ssy, __fmul_rn(mu1, su1));
    u[i] = __fsub_rn(u1, __fmul_rn(ef2, g2));
    v[i] = __fsub_rn(g2, __fmul_rn(ef2, u1));
  }
  const float rho2 = fsem::rcp_rn(guard(__fsub_rn(1.f, __fmul_rn(ef2, ef2))));
#pragma unroll
  for (int i = 0; i < A; ++i) {
    u[i] = __fmul_rn(u[i], rho2);
    v[i] = __fmul_rn(v[i], rho2);
    y[i] = __fadd_rn(y[i], __fmul_rn(mu2, u[i]));
  }
}

// the rounds whose writes reach register A - 1 ((k + 2) / 32 == A - 1, k
// even), then the next phase
template <int A, int P>
__device__ __forceinline__ void double_phases(const float (&r1)[P], const float (&r2)[P], float (&u)[P],
                                              float (&v)[P], float (&y)[P], const float* bn, int lane) {
#pragma unroll 1
  for (int k = A == 1 ? 0 : 32 * (A - 1) - 2; k <= 32 * A - 4; k += 2)
    double_round<A, P>(r1, r2, u, v, y, bn[k + 1], bn[k + 2], lane);
  if constexpr (A < P) double_phases<A + 1, P>(r1, r2, u, v, y, bn, lane);
}

template <int P>
__global__ void __launch_bounds__(32) levinson_double_warp_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out) {
  constexpr int n = 32 * P;
  __shared__ float bn_s[n];
  const int lane = threadIdx.x, row = blockIdx.x;
  const float* rr = r0 + (size_t)row * n;
  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  float r1[P], r2[P], u[P], v[P], y[P];
  load_system<P>(rr, b + (size_t)row * n, safe0, lane, r1, u, v, y, bn_s);
#pragma unroll
  for (int i = 0; i < P; ++i) {  // r2[j] = r1[j + 1], the same quotient
    const int j = 32 * i + lane;
    r2[i] = j < n - 2 ? __fdiv_rn(rr[j + 2], safe0) : 0.f;
  }
  __syncwarp();
  double_phases<1, P>(r1, r2, u, v, y, bn_s, lane);
  // n - 1 is odd: the last step, k = n - 2, alone (A5's step at width P)
  float pe[P], ry[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    pe[i] = __fmul_rn(r1[i], v[i]);
    ry[i] = __fmul_rn(r1[i], y[i]);
  }
  tree_sum<P, P>(pe);
  tree_sum<P, P>(ry);
  float s[2] = {pe[0], ry[0]};
  butterflies<2>(s);
  const float mu = __fsub_rn(bn_s[n - 1], s[1]);
  const float recip = fsem::rcp_rn(guard(__fsub_rn(1.f, __fmul_rn(s[0], s[0]))));
  float yn[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int prev = i > 0 ? i - 1 : 0;
    const float g = shift_right<1>(v[i], v[prev], i == 0, lane);
    const float gy = shift_right<1>(y[i], y[prev], i == 0, lane);
    yn[i] = __fadd_rn(gy, __fmul_rn(mu, __fmul_rn(__fsub_rn(u[i], __fmul_rn(s[0], g)), recip)));
  }
  store_reversed<P>(yn, x_out + (size_t)row * n, lane);
}

struct DoubleLaunch {
  template <int P>
  static void run(const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
    levinson_double_warp_kernel<P><<<batch, 32, 0, stream>>>(r0, b, x);
  }
};

}  // namespace

bool fsem::levinson_double(int n, const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
  return at_order<DoubleLaunch>(n, r0, b, x, batch, stream);
}
