// Batched Levinson-Durbin solve of symmetric Toeplitz systems T(r0) x = b.
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/levinson_pallas.py behind levinson_solve_fused(..., variant=...):
//   A5  _levinson_kernel (variant "vpu"): levinson_warp_kernel<P>, here,
//   A14 _levinson_kernel_flat ("flat", "flat_u4", "flat_u8"):
//       levinson_flat_warp_kernel<P, U> (levinson_flat.cu),
//       _levinson_kernel_dotreduce ("dotreduce"):
//       levinson_dotreduce_warp_kernel<P> (levinson_dotreduce.cu),
//       _levinson_kernel_double ("double"): levinson_double_warp_kernel<P>
//       (levinson_double.cu).
// The variants are one recursion with its reductions reassociated; on the
// TPU they trade lane work against reduction latency. Here all five run
// A5's design below, one warp per system, and each keeps its own trait;
// their helpers are in levinson.cuh, and each kernel family is a TU of its
// own so that nvcc builds them in parallel (in one TU their 192
// instantiations set the build's length).
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
// right shifts (shift_right: one __shfl_sync a register, lane 0 taking
// lane 31's previous register) before and between the butterflies'
// shuffles, u - ef g and g - ef u while the reciprocal runs. One warp
// issues every instruction, so the work per step is cut as well: before
// step k, u, v, y are zero past element k, so the steps run in phases,
// phase A touching registers 0 .. A - 1 only (A = (k + 1) / 32 + 1: half of
// the full width on average, as the TPU kernel's prefix widths). A lane's
// sum is a halving tree over its registers (odd lengths carry their last
// element up a level; r1 v over the k / 32 + 1 that hold elements 0 .. k,
// r1 y over the A of the step); every lane ends the butterfly with the
// same bits. The reciprocal is common.cuh's rcp_rn: __frcp_rn's value
// without its branch ahead of the result (53 cycles in a chain). bn[k+1]
// comes from a per-warp table in shared memory, read off the chain. Every
// operation is an explicitly rounded __fmul_rn / __fadd_rn / __fsub_rn (no
// contraction into FMAs), so the kernel computes exactly
// ops/levinson_pallas.py::_levinson_warp_order_reference, and differs from
// the plain recursion only in the order of the two sums. One row per
// block: at SDR's batch of 64 every warp has an SM of its own (2 and 4
// rows per block, and __frcp_rn or 1.f / d for rcp_rn, measured slower
// with the same bits).
//
// The A14 kernels are the same warp and registers, one 32-thread block per
// row and no block barrier, each with its TPU variant's trait:
// * levinson_flat_warp_kernel<P, U> ("flat", "flat_u4", "flat_u8"): A5's
//   step without the phases. Every step touches all P registers from step
//   0, as the TPU's flat kernel runs its full lane width, and both lane
//   sums run over all P registers; the step loop is unrolled U = 1, 4, 8
//   times (U = 1 as A5's 32-step blocks: a single loop spilled at one
//   order). The three share one arithmetic order, the reference's
//   phased=False twin, whose sums differ from A5's in their trees.
// * levinson_dotreduce_warp_kernel<P>: one butterfly carries both dot
//   products, as the TPU kernel gets both from one MXU product. Its first
//   level (16) exchanges one value, so that lanes 0-15 then hold the r1 v
//   partials and lanes 16-31 the r1 y partials; four single-shuffle levels
//   follow, then ef is broadcast from lane 0 and mu = bn[k+1] - <r1, y>
//   from lane 16 (six shuffle latencies on the chain, and six shuffles,
//   where A5 has five latencies and ten shuffles). bn[k+1] comes from a
//   register that rotates one lane to the left each step, off the chain
//   (lane 16 holds bn[k+1]; one global load a phase, issued a phase
//   ahead), instead of A5's shared table. It is phased as A5 and the JAX
//   dotreduce kernel are. Each level adds the same pairs as A5's
//   butterfly (float addition commutes), so it is A5 bit for bit.
// * levinson_double_warp_kernel<P>: two steps a round. Step k+1's
//   reductions are expanded in terms of step k's state: with r2 the
//   left-shifted r1, <r1, S(a)> = <r2, a>, so both steps need five
//   reductions of the current state, <r1,v>, <r2,v>, <r1,u>,
//   bn[k+1] - <r1,y>, bn[k+2] - <r2,y>: five interleaved butterflies, one
//   butterfly latency for two steps. Then two rcp_rn in chain (rho1, and
//   rho2 of ef2 = rho1 (<r2,v> - ef1 <r1,u>)), and the composed update on
//   S(v), S^2(v), S(u) and S^2(y) (S^2 a shuffle from lane l - 2, lanes 0
//   and 1 taking lanes 30 and 31's previous register). Phased: the round
//   at k writes elements up to k + 2, so it touches registers 0 .. A - 1
//   with A = (k + 2) / 32 + 1, and its five sums run over those A. The
//   n - 1 steps are odd for every order it takes (n = 32 P), so the last
//   one is A5's single step. x is y reversed here too (the composed update
//   mirrors as well); every operation explicitly rounded, so it is
//   ops/levinson_pallas.py::_levinson_double_warp_reference bit for bit,
//   a reassociation of the plain two-step version.
#include "levinson.cuh"

namespace {

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
  const float rf = rr[0];
  const float safe0 = fabsf(rf) < 1e-30f ? 1.f : rf;
  float r1[P], u[P], v[P], y[P];
  load_system<P>(rr, b + (size_t)row * n, safe0, lane, r1, u, v, y, bn_s);
  __syncwarp();
  // step 0's entry state: u_0 = 1 u_0, y_0 = y_0 + 0 u_0
  float se = __fmul_rn(r1[0], v[0]), recip = 1.f, mu = 0.f;
  warp_phases<1, P>(r1, u, v, y, se, recip, mu, bn_s, lane);
  finish_pipelined<P>(y, u, recip, mu, x_out + (size_t)row * n, lane);
}

struct WarpLaunch {
  template <int P>
  static void run(const float* r0, const float* b, float* x, int batch, cudaStream_t stream) {
    levinson_warp_kernel<P><<<batch, 32, 0, stream>>>(r0, b, x);
  }
};

}  // namespace

// r0, b, x: (batch, n) float32, n a multiple of 32 and at most 1024.
// variant: 0 "vpu" (A5), 1 "dotreduce", 2 "flat", 3 "flat_u4", 4 "flat_u8",
// 5 "double" (A14), the order of ops/levinson_pallas.py's VARIANTS.
extern "C" int fsem_levinson_solve(const float* r0, const float* b, float* x,
                                   int batch, int n, int variant, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  bool ok = false;
  switch (variant) {
    case 0: ok = at_order<WarpLaunch>(n, r0, b, x, batch, stream); break;
    case 1: ok = fsem::levinson_dotreduce(n, r0, b, x, batch, stream); break;
    case 2: ok = fsem::levinson_flat(1, n, r0, b, x, batch, stream); break;
    case 3: ok = fsem::levinson_flat(4, n, r0, b, x, batch, stream); break;
    case 4: ok = fsem::levinson_flat(8, n, r0, b, x, batch, stream); break;
    case 5: ok = fsem::levinson_double(n, r0, b, x, batch, stream); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
