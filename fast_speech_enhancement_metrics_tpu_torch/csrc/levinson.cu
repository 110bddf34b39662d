// Batched Levinson-Durbin solve of symmetric Toeplitz systems T(r0) x = b.
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/levinson_pallas.py behind levinson_solve_fused(..., variant=...):
//   A5  _levinson_kernel (variant "vpu"): levinson_warp_kernel<P>,
//   A14 _levinson_kernel_flat ("flat", "flat_u4", "flat_u8"),
//       _levinson_kernel_double ("double"),
//       _levinson_kernel_dotreduce ("dotreduce"): the block kernels below.
// The variants are one recursion with its reductions reassociated; on the
// TPU they trade lane work against reduction latency.
//
// What it computes, per row: with r1[j] = r0[j+1] / r0[0] (r1[n-1] = 0) and
// bn = b / r0[0] (r0[0] replaced by 1 when |r0[0]| < 1e-30), starting from
// u = v = e0, x = y = bn[0] e0, for k = 0 .. n-2:
//   ef = <r1, v>,  mu = bn[k+1] - <r1, y>,  g = shift_right(v)
//   denom = 1 - ef^2 (clamped to 1e-30 when |denom| < 1e-30)
//   u' = (u - ef g) / denom,  v' = (g - ef u) / denom
//   x' = x + mu v',  y' = shift_right(y) + mu u'
// and returns x. v and y are the reversals of u and x, carried so that
// every step is a fixed-width update.
//
// What bounds it on this card: latency. The n - 1 = 511 steps are a chain,
// each waiting on the two reductions of the previous step's state; the
// arithmetic (about 10 n flops a step) and the bytes (three (B, n) arrays,
// 0.4 MB at batch 64) are tiny next to it. The chain's floor per step is
// a product, a log2(n)-level add tree, 1 - ef^2, one correctly rounded
// reciprocal and the update's two dependent products, 16 operations at
// n = 512 (chip_smoke.py prints that floor beside the kernel's time, at an
// assumed 4 cycles an operation). What a warp can reach is longer: on an
// H100 (tools/chain_latency.py) a shuffle-and-add level takes 29 cycles,
// so the five levels of a warp's sum 147, and __frcp_rn 80 cycles.
//
// A5, levinson_warp_kernel<P>: one warp per system, so no step waits on a
// block barrier or a shared-memory round trip of its partial sums. Element
// 32 i + l of r1, u, v and y lives in register i of lane l (P = n / 32
// registers each) for the whole solve; x is not carried: it is y reversed
// after every step, bit for bit (the same operations on mirrored
// elements), so the kernel writes the last y reversed. A step's chain is
// the two interleaved five-level xor butterflies (16, 8, 4, 2, 1) of the
// lanes' sums of r1 v and r1 y, 1 - ef^2 and its guard, the reciprocal,
// and v' with the next step's r1 v' lane sums. The rest is issued in its
// shadow (warp_step, software-pipelined by one step): the previous step's
// u' = tu recip and y' = S(y) + mu u' (with their r1 y' sums) and the
// right shifts (one __shfl_sync a register, lane 0 taking lane 31's
// previous register) before and between the butterflies' shuffles, u - ef
// g and g - ef u while the reciprocal runs. One warp issues every
// instruction, so the work per step is cut as well: before step k, u, v,
// y are zero past element k, so the steps run in phases, phase A touching
// registers 0 .. A - 1 only (A = (k + 1) / 32 + 1: half of the full width
// on average, as the TPU kernel's prefix widths). A lane's sum is a
// halving tree over its registers (odd lengths carry their last element up
// a level; r1 v over the k / 32 + 1 that hold elements 0 .. k, r1 y over
// the A of the step); every lane ends the butterfly with the same bits.
// The reciprocal is common.cuh's rcp_rn: __frcp_rn's value without its
// branch ahead of the result (53 cycles in a chain). bn[k+1] comes from a
// per-warp table in shared memory, read off the chain. Every operation is
// an explicitly rounded __fmul_rn / __fadd_rn / __fsub_rn (no contraction
// into FMAs), so the kernel computes exactly
// ops/levinson_pallas.py::_levinson_warp_order_reference, and differs from
// the plain recursion only in the order of the two sums. One row per
// block: at SDR's batch of 64 every warp has an SM of its own (2 and 4
// rows per block, and __frcp_rn or 1.f / d for rcp_rn, measured slower
// with the same bits).
//
// The A14 block kernels: one block per row, one thread per coefficient (n
// threads, n a multiple of 32 up to 1024); u, v, x, y live in registers
// for the whole solve. A reduction is a warp shuffle butterfly, one
// shared-memory slot per warp, one __syncthreads, and every thread adds
// the warp slots in the same order. A right shift is a warp shuffle, with
// the low lanes taking the previous warp's last lanes from shared memory.
// The slots are double-buffered so one barrier per reduction round
// suffices.
// * levinson_kernel<U> ("flat", "flat_u4", "flat_u8"): one step per round,
//   the step loop unrolled U times; the three share one arithmetic order.
//   The TPU's "vpu" runs its early steps on a prefix of the lanes; these
//   run the full width from the start.
// * levinson_dotreduce_kernel: both dots of a step in one butterfly (lanes
//   0-15 carry <r1, v>, lanes 16-31 <r1, y>: five shuffles where two
//   reductions take ten), and bn[k+1] from a register that shifts left one
//   lane a step, where the other kernels read a shared table. The butterfly
//   adds the same pairs in the same tree as "flat"'s, but the compiler
//   fuses its first add with a product differently, so it agrees with
//   "flat" to round-off, not bit for bit.
// * levinson_double_kernel: two steps per round. Step k+1's reductions are
//   expanded in terms of step k's state: with r2 the left-shifted r1,
//   <r1, S(a)> = <r2, a>, so both steps need five reductions of the current
//   state, <r1,v>, <r2,v>, <r1,u>, bn[k+1] - <r1,y>, bn[k+2] - <r2,y>, in one
//   round (one barrier per two steps), and the composed update shifts by one
//   and two lanes: each warp publishes its last two lanes. Another
//   reassociation: agrees with the others to about cond x 1e-7.
#include <utility>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

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

// One recursion step k of A5, writing registers 0 .. A - 1 of each lane
// (A = (k + 1) / 32 + 1: elements up to k + 1; every later element of u,
// v, y is still 0), software-pipelined by one step: on entry v holds v_k,
// u holds u_k before its scaling (tu = u_{k-1} - ef g) and y holds
// shift_right(y_{k-1}) (gy), with the scalars recip and mu of step k - 1
// (1 and 0 before step 0), and se the lanes' sums of r1 v_k. The step
// first finishes u_k = tu recip and y_k = gy + mu u_k and sums r1 y_k over
// A registers, then runs the two butterflies and shifts v_k and y_k; while
// the reciprocal runs it forms u_k - ef g and g - ef u_k; after it, v_{k+1}
// and the next r1 v sums.
template <int A, int P>
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
  float ef = se, s = ry[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float te = __shfl_xor_sync(fsem::kFullMask, ef, o);
    const float ts = __shfl_xor_sync(fsem::kFullMask, s, o);
    ef = __fadd_rn(ef, te);
    s = __fadd_rn(s, ts);
  }
  // shift_right: element 32 i + l takes element 32 i + l - 1, lane l - 1's
  // register i, or for lane 0 lane 31's register i - 1 (0 for element 0)
  const int src = (lane + 31) & 31;
  float g[A], gy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const bool wrap = i > 0 && lane == 31;
    const int prev = i > 0 ? i - 1 : 0;
    g[i] = __shfl_sync(fsem::kFullMask, wrap ? v[prev] : v[i], src);
    gy[i] = __shfl_sync(fsem::kFullMask, wrap ? y[prev] : y[i], src);
  }
  if (lane == 0) {
    g[0] = 0.f;
    gy[0] = 0.f;
  }
  recip = fsem::rcp_rn(guard(__fsub_rn(1.f, __fmul_rn(ef, ef))));
  float tv[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    tv[i] = __fsub_rn(g[i], __fmul_rn(ef, u[i]));
    u[i] = __fsub_rn(u[i], __fmul_rn(ef, g[i]));
    y[i] = gy[i];
  }
  mu = __fsub_rn(bn_next, s);
  float pe[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    v[i] = __fmul_rn(tv[i], recip);
    pe[i] = __fmul_rn(r1[i], v[i]);
  }
  tree_sum<A, A>(pe);
  se = pe[0];
}

// the steps k whose writes reach register A - 1 ((k + 1) / 32 == A - 1),
// then the next phase
template <int A, int P>
__device__ __forceinline__ void warp_phases(const float (&r1)[P], float (&u)[P], float (&v)[P], float (&y)[P],
                                            float& se, float& recip, float& mu, const float* bn, int lane) {
#pragma unroll 1
  for (int k = A == 1 ? 0 : 32 * (A - 1) - 1; k < 32 * A - 1; ++k)
    warp_step<A, P>(r1, u, v, y, se, recip, mu, bn[k + 1], lane);
  if constexpr (A < P) warp_phases<A + 1, P>(r1, u, v, y, se, recip, mu, bn, lane);
}

template <int P>
__global__ void __launch_bounds__(32) levinson_warp_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out) {
  constexpr int n = 32 * P;
  __shared__ float bn_s[n];
  const int lane = threadIdx.x, row = blockIdx.x;
  const float* rr = r0 + (size_t)row * n;
  const float* br = b + (size_t)row * n;

  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  // element 32 i + lane in register i
  float r1[P], u[P], v[P], y[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = 32 * i + lane;
    r1[i] = j < n - 1 ? __fdiv_rn(rr[j + 1], safe0) : 0.f;
    const float bnj = __fdiv_rn(br[j], safe0);
    bn_s[j] = bnj;
    u[i] = v[i] = j == 0 ? 1.f : 0.f;
    y[i] = j == 0 ? bnj : 0.f;
  }
  __syncwarp();
  // step 0's entry state: u_0 = 1 u_0, y_0 = y_0 + 0 u_0
  float se = __fmul_rn(r1[0], v[0]), recip = 1.f, mu = 0.f;
  warp_phases<1, P>(r1, u, v, y, se, recip, mu, bn_s, lane);
  // the last step's y; x is its reversal, bit for bit: v is u reversed and
  // y is x reversed after every step (the same operations on mirrored
  // elements), so x itself is never carried. Element e = 32 i + l of x is
  // element n - 1 - e of y, lane 31 - l's register P - 1 - i.
#pragma unroll
  for (int i = 0; i < P; ++i) y[i] = __fadd_rn(y[i], __fmul_rn(mu, __fmul_rn(u[i], recip)));
  float* xo = x_out + (size_t)row * n + lane;
#pragma unroll
  for (int i = 0; i < P; ++i) xo[32 * i] = __shfl_sync(fsem::kFullMask, y[P - 1 - i], 31 - lane);
}

template <int P>
void launch_warp(const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
  levinson_warp_kernel<P><<<batch, 32, 0, stream>>>(r0, b, x);
}

// A5 at order n = 32 P, P = 1 .. 32
template <int... Ps>
bool dispatch_warp(std::integer_sequence<int, Ps...>, int n, const float* r0, const float* b, float* x,
                   int batch, cudaStream_t stream) {
  return ((n == 32 * (Ps + 1) ? (launch_warp<Ps + 1>(r0, b, x, batch, stream), true) : false) || ...);
}

template <int kUnroll>
__global__ void __launch_bounds__(1024) levinson_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out, int n) {
  __shared__ float bn_s[32 * kMaxWarps];
  __shared__ float2 red[2][kMaxWarps];   // per warp: (<r1, v>, <r1, y>)
  __shared__ float2 edge[2][kMaxWarps];  // per warp: last lane's (v, y)
  const int row = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;
  const float* rr = r0 + (size_t)row * n;

  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  const float r1 = j < n - 1 ? rr[j + 1] / safe0 : 0.f;
  const float bnj = b[(size_t)row * n + j] / safe0;
  bn_s[j] = bnj;
  float u = j == 0 ? 1.f : 0.f, v = u;
  float x = j == 0 ? bnj : 0.f, y = x;
  __syncthreads();

#pragma unroll (kUnroll)
  for (int k = 0; k < n - 1; ++k) {
    const int buf = k & 1;
    const float pe = fsem::warp_sum(r1 * v);
    const float py = fsem::warp_sum(r1 * y);
    if (lane == 0) red[buf][warp] = make_float2(pe, py);
    if (lane == 31) edge[buf][warp] = make_float2(v, y);
    __syncthreads();
    float ef = 0.f, ry = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float2 p = red[buf][w];
      ef += p.x;
      ry += p.y;
    }
    float gv = __shfl_up_sync(fsem::kFullMask, v, 1);
    float gy = __shfl_up_sync(fsem::kFullMask, y, 1);
    if (lane == 0) {
      if (warp == 0) {
        gv = 0.f;
        gy = 0.f;
      } else {
        const float2 e = edge[buf][warp - 1];
        gv = e.x;
        gy = e.y;
      }
    }
    const float mu = bn_s[k + 1] - ry;
    const float recip = 1.f / guard(1.f - ef * ef);
    const float un = (u - ef * gv) * recip;
    const float vn = (gv - ef * u) * recip;
    x = x + mu * vn;
    y = gy + mu * un;
    u = un;
    v = vn;
  }
  x_out[(size_t)row * n + j] = x;
}

__global__ void __launch_bounds__(1024) levinson_dotreduce_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out, int n) {
  __shared__ float2 red[2][kMaxWarps];   // per warp: (<r1, v>, <r1, y>)
  __shared__ float2 edge[2][kMaxWarps];  // per warp: last lane's (v, y)
  __shared__ float head[2][kMaxWarps];   // per warp: first lane's shifted bn
  const int row = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;
  const float* rr = r0 + (size_t)row * n;
  const float* br = b + (size_t)row * n;

  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  const float r1 = j < n - 1 ? rr[j + 1] / safe0 : 0.f;
  const float bnj = br[j] / safe0;
  float bnc = j < n - 1 ? br[j + 1] / safe0 : 0.f;  // bn shifted left by one: lane 0 holds bn[k+1]
  float u = j == 0 ? 1.f : 0.f, v = u;
  float x = j == 0 ? bnj : 0.f, y = x;

  for (int k = 0; k < n - 1; ++k) {
    const int buf = k & 1;
    // one butterfly for both dots: lanes 0-15 sum r1 v, lanes 16-31 r1 y
    const bool lo = lane < 16;
    float mine = lo ? r1 * v : r1 * y;
    mine += __shfl_xor_sync(fsem::kFullMask, lo ? r1 * y : r1 * v, 16);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mine += __shfl_xor_sync(fsem::kFullMask, mine, o);
    if (lane == 0) red[buf][warp].x = mine;
    if (lane == 16) red[buf][warp].y = mine;
    if (lane == 31) edge[buf][warp] = make_float2(v, y);
    if (lane == 0) head[buf][warp] = bnc;
    __syncthreads();
    float ef = 0.f, ry = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float2 p = red[buf][w];
      ef += p.x;
      ry += p.y;
    }
    float gv = __shfl_up_sync(fsem::kFullMask, v, 1);
    float gy = __shfl_up_sync(fsem::kFullMask, y, 1);
    if (lane == 0) {
      if (warp == 0) {
        gv = 0.f;
        gy = 0.f;
      } else {
        const float2 e = edge[buf][warp - 1];
        gv = e.x;
        gy = e.y;
      }
    }
    const float mu = head[buf][0] - ry;
    float bn_next = __shfl_down_sync(fsem::kFullMask, bnc, 1);
    if (lane == 31) bn_next = warp + 1 < n_warps ? head[buf][warp + 1] : 0.f;
    bnc = bn_next;
    const float recip = 1.f / guard(1.f - ef * ef);
    const float un = (u - ef * gv) * recip;
    const float vn = (gv - ef * u) * recip;
    x = x + mu * vn;
    y = gy + mu * un;
    u = un;
    v = vn;
  }
  x_out[(size_t)row * n + j] = x;
}

// a's value one (kBy = 1) or two lanes to the left across the block; the
// low lanes of a warp read the previous warp's last two lanes (prev1 is its
// lane 31, prev2 its lane 30); warp 0's take the zero fill
template <int kBy>
__device__ __forceinline__ float shifted(float a, float prev1, float prev2, int lane, int warp) {
  float s = __shfl_up_sync(fsem::kFullMask, a, kBy);
  if (lane < kBy) {
    if (warp == 0) {
      s = 0.f;
    } else {
      s = (kBy == 1 || lane == 1) ? prev1 : prev2;
    }
  }
  return s;
}

__global__ void __launch_bounds__(1024) levinson_double_kernel(
    const float* __restrict__ r0, const float* __restrict__ b,
    float* __restrict__ x_out, int n) {
  constexpr int kSums = 5, kEdges = 5;
  __shared__ float bn_s[32 * kMaxWarps];
  __shared__ float red[2][kMaxWarps][kSums];
  // per warp: v[30], v[31], u[31], y[30], y[31]
  __shared__ float edge[2][kMaxWarps][kEdges];
  const int row = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;
  const float* rr = r0 + (size_t)row * n;

  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  const float r1 = j < n - 1 ? rr[j + 1] / safe0 : 0.f;
  const float r2 = j < n - 2 ? rr[j + 2] / safe0 : 0.f;  // r1 shifted left, last lane 0
  const float bnj = b[(size_t)row * n + j] / safe0;
  bn_s[j] = bnj;
  float u = j == 0 ? 1.f : 0.f, v = u;
  float x = j == 0 ? bnj : 0.f, y = x;
  __syncthreads();

  const int steps = n - 1;
  for (int i = 0; i < steps / 2; ++i) {
    const int k = 2 * i, buf = i & 1;
    const float s0 = fsem::warp_sum(r1 * v);
    const float s1 = fsem::warp_sum(r2 * v);
    const float s2 = fsem::warp_sum(r1 * u);
    const float s3 = fsem::warp_sum(r1 * y);
    const float s4 = fsem::warp_sum(r2 * y);
    if (lane == 0) {
      float* slot = red[buf][warp];
      slot[0] = s0;
      slot[1] = s1;
      slot[2] = s2;
      slot[3] = s3;
      slot[4] = s4;
    }
    if (lane == 30) {
      edge[buf][warp][0] = v;
      edge[buf][warp][3] = y;
    }
    if (lane == 31) {
      edge[buf][warp][1] = v;
      edge[buf][warp][2] = u;
      edge[buf][warp][4] = y;
    }
    __syncthreads();
    float ef1 = 0.f, p = 0.f, uu = 0.f, ry1 = 0.f, ry2 = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* slot = red[buf][w];
      ef1 += slot[0];
      p += slot[1];
      uu += slot[2];
      ry1 += slot[3];
      ry2 += slot[4];
    }
    const float mu1 = bn_s[k + 1] - ry1;
    const float q2 = bn_s[k + 2] - ry2;
    const float rho1 = 1.f / guard(1.f - ef1 * ef1);
    const float ef2 = rho1 * (p - ef1 * uu);
    const float rho2 = 1.f / guard(1.f - ef2 * ef2);
    const float mu2 = q2 - mu1 * rho1 * (uu - ef1 * p);

    const float* pe = warp > 0 ? edge[buf][warp - 1] : edge[buf][0];
    const float sv = shifted<1>(v, pe[1], pe[0], lane, warp);
    const float ssv = shifted<2>(v, pe[1], pe[0], lane, warp);
    const float su = shifted<1>(u, pe[2], pe[2], lane, warp);
    const float ssy = shifted<2>(y, pe[4], pe[3], lane, warp);

    const float u1 = (u - ef1 * sv) * rho1;
    const float v1 = (sv - ef1 * u) * rho1;
    const float g2 = rho1 * (ssv - ef1 * su);
    const float u2 = (u1 - ef2 * g2) * rho2;
    const float v2 = (g2 - ef2 * u1) * rho2;
    x = x + mu1 * v1 + mu2 * v2;
    const float su1 = rho1 * (su - ef1 * ssv);
    y = ssy + mu1 * su1 + mu2 * u2;
    u = u2;
    v = v2;
  }
  if (steps % 2) {  // the last single step, k = n - 2
    const int k = steps - 1, buf = (steps / 2) & 1;
    const float pe = fsem::warp_sum(r1 * v);
    const float py = fsem::warp_sum(r1 * y);
    if (lane == 0) {
      red[buf][warp][0] = pe;
      red[buf][warp][3] = py;
    }
    if (lane == 31) {
      edge[buf][warp][1] = v;
      edge[buf][warp][4] = y;
    }
    __syncthreads();
    float ef = 0.f, ry = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      ef += red[buf][w][0];
      ry += red[buf][w][3];
    }
    const float* prev = warp > 0 ? edge[buf][warp - 1] : edge[buf][0];
    const float gv = shifted<1>(v, prev[1], prev[1], lane, warp);
    const float gy = shifted<1>(y, prev[4], prev[4], lane, warp);
    const float mu = bn_s[k + 1] - ry;
    const float recip = 1.f / guard(1.f - ef * ef);
    const float un = (u - ef * gv) * recip;
    const float vn = (gv - ef * u) * recip;
    x = x + mu * vn;
    y = gy + mu * un;
  }
  x_out[(size_t)row * n + j] = x;
}

}  // namespace

// r0, b, x: (batch, n) float32, n a multiple of 32 and at most 1024.
// variant: 0 "vpu" (A5), 1 "dotreduce", 2 "flat", 3 "flat_u4", 4 "flat_u8",
// 5 "double" (A14), the order of ops/levinson_pallas.py's VARIANTS.
extern "C" int fsem_levinson_solve(const float* r0, const float* b, float* x,
                                   int batch, int n, int variant, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) {
    case 0:
      if (n % 32 || !dispatch_warp(std::make_integer_sequence<int, 32>{}, n, r0, b, x, batch, stream))
        return (int)cudaErrorInvalidValue;
      break;
    case 2: levinson_kernel<1><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 1: levinson_dotreduce_kernel<<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 3: levinson_kernel<4><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 4: levinson_kernel<8><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 5: levinson_double_kernel<<<batch, n, 0, stream>>>(r0, b, x, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
