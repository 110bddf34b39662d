// Batched Levinson-Durbin solve of symmetric Toeplitz systems T(r0) x = b.
//
// Replaces: ops/levinson_pallas.py::_levinson_kernel of the JAX package
// (Pallas, TPU; variant "vpu"), the kernel behind levinson_solve_fused.
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
// each waiting on two block-wide reductions of the previous step's state;
// the arithmetic (about 10 n flops a step) and the bytes (three (B, n)
// arrays, 0.4 MB at batch 64) are tiny next to it.
//
// Design: one block per row, one thread per coefficient (n threads, n a
// multiple of 32 up to 1024); u, v, x, y live in registers for the whole
// solve. Each step reduces ef and <r1, y> together: a warp shuffle
// butterfly, one shared-memory slot per warp, one __syncthreads, and every
// thread adds the warp slots in the same order. The right shift is a warp
// shuffle, with lane 0 taking the previous warp's last lane from shared
// memory. The slots are double-buffered so one barrier a step suffices.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

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
    float denom = 1.f - ef * ef;
    if (fabsf(denom) < 1e-30f) denom = 1e-30f;
    const float recip = 1.f / denom;
    const float un = (u - ef * gv) * recip;
    const float vn = (gv - ef * u) * recip;
    x = x + mu * vn;
    y = gy + mu * un;
    u = un;
    v = vn;
  }
  x_out[(size_t)row * n + j] = x;
}

}  // namespace

// r0, b, x: (batch, n) float32, n a multiple of 32 and at most 1024.
extern "C" int fsem_levinson_solve(const float* r0, const float* b, float* x,
                                   int batch, int n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  levinson_kernel<<<batch, n, 0, stream>>>(r0, b, x, n);
  return (int)cudaGetLastError();
}
