// Batched Levinson-Durbin solve of symmetric Toeplitz systems T(r0) x = b.
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/levinson_pallas.py behind levinson_solve_fused(..., variant=...):
//   A5  _levinson_kernel (variant "vpu"),
//   A14 _levinson_kernel_flat ("flat", "flat_u4", "flat_u8"),
//       _levinson_kernel_double ("double"),
//       _levinson_kernel_dotreduce ("dotreduce").
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
// each waiting on block-wide reductions of the previous step's state; the
// arithmetic (about 10 n flops a step) and the bytes (three (B, n) arrays,
// 0.4 MB at batch 64) are tiny next to it.
//
// Design: one block per row, one thread per coefficient (n threads, n a
// multiple of 32 up to 1024); u, v, x, y live in registers for the whole
// solve. A reduction is a warp shuffle butterfly, one shared-memory slot per
// warp, one __syncthreads, and every thread adds the warp slots in the same
// order. A right shift is a warp shuffle, with the low lanes taking the
// previous warp's last lanes from shared memory. The slots are
// double-buffered so one barrier per reduction round suffices.
// * levinson_kernel<U> ("vpu", "flat", "flat_u4", "flat_u8"): one step per
//   round, the step loop unrolled U times. The TPU's "vpu" runs its early
//   steps on a prefix of the lanes; here every variant runs the full width
//   from the start, so these four share one arithmetic order.
// * levinson_dotreduce_kernel: both dots of a step in one butterfly (lanes
//   0-15 carry <r1, v>, lanes 16-31 <r1, y>: five shuffles where two
//   reductions take ten), and bn[k+1] from a register that shifts left one
//   lane a step, where the other kernels read a shared table. The butterfly
//   adds the same pairs in the same tree as A5's, but the compiler fuses
//   its first add with a product differently, so it agrees with A5 to
//   round-off, not bit for bit.
// * levinson_double_kernel: two steps per round. Step k+1's reductions are
//   expanded in terms of step k's state: with r2 the left-shifted r1,
//   <r1, S(a)> = <r2, a>, so both steps need five reductions of the current
//   state, <r1,v>, <r2,v>, <r1,u>, bn[k+1] - <r1,y>, bn[k+2] - <r2,y>, in one
//   round (one barrier per two steps), and the composed update shifts by one
//   and two lanes: each warp publishes its last two lanes. Another
//   reassociation: agrees with the others to about cond x 1e-7.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float guard(float d) { return fabsf(d) < 1e-30f ? 1e-30f : d; }

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
    case 2: levinson_kernel<1><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 1: levinson_dotreduce_kernel<<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 3: levinson_kernel<4><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 4: levinson_kernel<8><<<batch, n, 0, stream>>>(r0, b, x, n); break;
    case 5: levinson_double_kernel<<<batch, n, 0, stream>>>(r0, b, x, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
