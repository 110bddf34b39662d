// Device helpers of the Levinson warp kernels (levinson.cu: A5 and the
// entry point; levinson_flat.cu, levinson_dotreduce.cu, levinson_double.cu:
// A14), one TU each so that nvcc builds them in parallel; the design is
// described in levinson.cu.
#pragma once

#include <cuda_runtime.h>

#include <utility>

#include "common.cuh"

namespace fsem {

// each A14 kernel at order n (32 .. 1024 in steps of 32) on `batch` rows,
// one 32-thread block a row; false for any other order
bool levinson_flat(int unroll, int n, const float* r0, const float* b, float* x, int batch, cudaStream_t stream);
bool levinson_dotreduce(int n, const float* r0, const float* b, float* x, int batch, cudaStream_t stream);
bool levinson_double(int n, const float* r0, const float* b, float* x, int batch, cudaStream_t stream);

}  // namespace fsem

namespace {

// Launch::run<P>(args...) for the P with n == 32 P, P = 1 .. 32: one
// instantiation per order; false when n is none of them
template <class Launch, int... Ps, class... Args>
bool at_order(std::integer_sequence<int, Ps...>, int n, Args... args) {
  return ((n == 32 * (Ps + 1) ? (Launch::template run<Ps + 1>(args...), true) : false) || ...);
}

template <class Launch, class... Args>
bool at_order(int n, Args... args) {
  return at_order<Launch>(std::make_integer_sequence<int, 32>{}, n, args...);
}

__device__ __forceinline__ float guard(float d) { return fabsf(d) < 1e-30f ? 1e-30f : d; }

// a[0] <- the halving-tree sum of a[0 .. M-1]: a[i] += a[i + M/2] for
// i < M/2, an odd M's last element moved up to a[M/2], M -> ceil(M/2)
template <int M, int P>
__device__ __forceinline__ void tree_sum(float (&a)[P]) {
  if constexpr (M > 1) {
    constexpr int h = M / 2;
#pragma unroll
    for (int i = 0; i < h; ++i) a[i] = __fadd_rn(a[i], a[i + h]);
    if constexpr (M % 2) a[h] = a[2 * h];
    tree_sum<(M + 1) / 2, P>(a);
  }
}

// Element 32 i + l of a shifted right by kBy (1 or 2) elements: lane
// l - kBy's register i, or for the low lanes lane 32 - kBy + l's register
// i - 1 (the zero fill for i = 0). cur, prev: the calling lane's registers
// i and i - 1 (prev = cur for i = 0); every lane sends the one its
// receiver needs.
template <int kBy>
__device__ __forceinline__ float shift_right(float cur, float prev, bool first, int lane) {
  const float s = __shfl_sync(fsem::kFullMask, lane >= 32 - kBy ? prev : cur, (lane + 32 - kBy) & 31);
  return first && lane < kBy ? 0.f : s;
}

// The sum over the warp of each lane's x[c]: C interleaved xor butterflies
// (16, 8, 4, 2, 1); every lane ends with the same bits.
template <int C>
__device__ __forceinline__ void butterflies(float (&x)[C]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = __shfl_xor_sync(fsem::kFullMask, x[c], o);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = __fadd_rn(x[c], t[c]);
  }
}

// The row's normalised system, element 32 i + lane in register i: r1,
// u = v = e0, y = bn[0] e0; bn to the per-warp table when one is given
template <int P>
__device__ __forceinline__ void load_system(const float* rr, const float* br, float safe0, int lane, float (&r1)[P],
                                            float (&u)[P], float (&v)[P], float (&y)[P], float* bn_s) {
  constexpr int n = 32 * P;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = 32 * i + lane;
    r1[i] = j < n - 1 ? __fdiv_rn(rr[j + 1], safe0) : 0.f;
    const float bnj = __fdiv_rn(br[j], safe0);
    if (bn_s != nullptr) bn_s[j] = bnj;
    u[i] = v[i] = j == 0 ? 1.f : 0.f;
    y[i] = j == 0 ? bnj : 0.f;
  }
}

// x, element e = 32 i + l, is element n - 1 - e of the last y: lane
// 31 - l's register P - 1 - i
template <int P>
__device__ __forceinline__ void store_reversed(const float (&y)[P], float* x_row, int lane) {
#pragma unroll
  for (int i = 0; i < P; ++i) x_row[32 * i + lane] = __shfl_sync(fsem::kFullMask, y[P - 1 - i], 31 - lane);
}

// One recursion step k of A5, writing registers 0 .. A - 1 of each lane
// (A = (k + 1) / 32 + 1: elements up to k + 1; every later element of u,
// v, y is still 0), software-pipelined by one step: on entry v holds v_k,
// u holds u_k before its scaling (tu = u_{k-1} - ef g) and y holds
// shift_right(y_{k-1}) (gy), with the scalars recip and mu of step k - 1
// (1 and 0 before step 0), and se the lanes' sums of r1 v_k. The step
// first finishes u_k = tu recip and y_k = gy + mu u_k and sums r1 y_k over
// A registers, then runs the two butterflies and shifts v_k and y_k; while
// the reciprocal runs it forms u_k - ef g and g - ef u_k; after it, v_{k+1}
// and the next r1 v sums. kSplit (dotreduce): both sums in one butterfly,
// and bn_next is the lane's rotating bn register (lane 16's is bn[k+1]).
template <int A, int P, bool kSplit = false>
__device__ __forceinline__ void warp_step(const float (&r1)[P], float (&u)[P], float (&v)[P], float (&y)[P],
                                          float& se, float& recip, float& mu, float bn_next, int lane) {
  float ry[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    u[i] = __fmul_rn(u[i], recip);
    y[i] = __fadd_rn(y[i], __fmul_rn(mu, u[i]));
    ry[i] = __fmul_rn(r1[i], y[i]);
  }
  tree_sum<A, A>(ry);
  float ef, s;
  if constexpr (kSplit) {
    // level 16 exchanges one value: lanes 0-15 keep the r1 v partials,
    // lanes 16-31 the r1 y partials; then one shuffle a level
    const bool lo = lane < 16;
    float h = __fadd_rn(lo ? se : ry[0], __shfl_xor_sync(fsem::kFullMask, lo ? ry[0] : se, 16));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) h = __fadd_rn(h, __shfl_xor_sync(fsem::kFullMask, h, o));
    ef = __shfl_sync(fsem::kFullMask, h, 0);
    s = __shfl_sync(fsem::kFullMask, __fsub_rn(bn_next, h), 16);  // mu itself
  } else {
    float e2[2] = {se, ry[0]};
    butterflies<2>(e2);
    ef = e2[0];
    s = e2[1];
  }
  float g[A], gy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    g[i] = shift_right<1>(v[i], v[i > 0 ? i - 1 : 0], i == 0, lane);
    gy[i] = shift_right<1>(y[i], y[i > 0 ? i - 1 : 0], i == 0, lane);
  }
  recip = fsem::rcp_rn(guard(__fsub_rn(1.f, __fmul_rn(ef, ef))));
  float tv[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    tv[i] = __fsub_rn(g[i], __fmul_rn(ef, u[i]));
    u[i] = __fsub_rn(u[i], __fmul_rn(ef, g[i]));
    y[i] = gy[i];
  }
  mu = kSplit ? s : __fsub_rn(bn_next, s);
  float pe[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    v[i] = __fmul_rn(tv[i], recip);
    pe[i] = __fmul_rn(r1[i], v[i]);
  }
  tree_sum<A, A>(pe);
  se = pe[0];
}

// the last step's y (finishing the pipelined u and y), written reversed
template <int P>
__device__ __forceinline__ void finish_pipelined(float (&y)[P], const float (&u)[P], float recip, float mu,
                                                 float* x_row, int lane) {
#pragma unroll
  for (int i = 0; i < P; ++i) y[i] = __fadd_rn(y[i], __fmul_rn(mu, __fmul_rn(u[i], recip)));
  store_reversed<P>(y, x_row, lane);
}

}  // namespace
