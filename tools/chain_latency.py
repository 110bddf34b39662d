"""Measure the dependent-issue latencies that bound a chain like A5's (the Levinson recursion) on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/chain_latency.py

Builds a small CUDA library (the source is below; nvcc for sm_90a, into
the package's git-ignored ``_build_latency/``) whose kernel runs, in one
warp, 4096 iterations of a chain in which every iteration waits on the
last, and reads the SM clock (``clock64``) around the loop. Prints the
card's name and power limit, then one JSON line of cycles per iteration
for each chain: a float32 add, a multiply, an FMA; one level of an xor
shuffle butterfly (``__shfl_xor_sync`` then an add); a shared-memory load
whose address is the last load's value; the correctly rounded reciprocal
``__frcp_rn`` and ``csrc/common.cuh``'s ``rcp_rn`` (the same values); one
A5 step's scalar chain at one register a lane (the two products, two
interleaved five-level butterflies, 1 - ef^2, the guard, the reciprocal,
u' and y') with either reciprocal, and with ``rcp_rn`` and the
butterfly's five levels through shared memory instead. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib  # noqa: E402

ITERS = 4096
CHAINS = ("fadd", "fmul", "ffma", "shfl_fadd", "lds", "frcp_rn", "rcp_rn", "a5_step_frcp_rn", "a5_step_rcp_rn",
          "a5_step_smem")

SOURCE = r"""
#include "common.cuh"
#define FULL 0xffffffffu

__device__ __forceinline__ float butterfly(float a, float (*part)[32], int lane, int k, bool smem) {
  if (!smem) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
    return a;
  }
  part[k & 1][lane] = a;
  __syncwarp();
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = part[k & 1][i];
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) s[i] = __fadd_rn(s[i], s[i + h]);
  return s[0];
}

template <int W>
__global__ void chain_kernel(int iters, float seed, float* out, long long* cycles) {
  __shared__ int ring[32];
  __shared__ float part[2][2][32];
  const int lane = threadIdx.x;
  ring[lane] = (lane + 1) & 31;
  __syncwarp();
  // r1 is 0 at run time (not known to the compiler), so the step's values stay put
  const float r1 = seed - 1.0001f;
  float a = seed + lane * 1e-3f, u = 1.f, y = 0.5f;
  int p = lane;
  const long long t0 = clock64();
  for (int k = 0; k < iters; ++k) {
    if constexpr (W == 0) a = __fadd_rn(a, 1e-7f);
    if constexpr (W == 1) a = __fmul_rn(a, 0.9999f);
    if constexpr (W == 2) a = __fmaf_rn(a, 0.9999f, 1e-7f);
    if constexpr (W == 3) a = __fadd_rn(a, __shfl_xor_sync(FULL, a, 1));
    if constexpr (W == 4) p = ring[p];
    if constexpr (W == 5) a = __frcp_rn(a);
    if constexpr (W == 6) a = fsem::rcp_rn(a);
    if constexpr (W >= 7) {  // one A5 step at one register a lane
      const bool smem = W == 9;
      const float ef = butterfly(__fmul_rn(r1, a), part[0], lane, k, smem);
      const float ry = butterfly(__fmul_rn(r1, y), part[1], lane, k, smem);
      const float g = __shfl_sync(FULL, a, (lane + 31) & 31);
      const float mu = __fsub_rn(0.25f, ry);
      float d = __fsub_rn(1.f, __fmul_rn(ef, ef));
      d = fabsf(d) < 1e-30f ? 1e-30f : d;
      const float recip = W == 7 ? __frcp_rn(d) : fsem::rcp_rn(d);
      const float un = __fmul_rn(__fsub_rn(u, __fmul_rn(ef, g)), recip);
      const float vn = __fmul_rn(__fsub_rn(g, __fmul_rn(ef, u)), recip);
      y = __fadd_rn(g, __fmul_rn(mu, un));
      u = un;
      a = vn;
    }
  }
  const long long t1 = clock64();
  out[lane] = a + y + (float)p;
  if (lane == 0) *cycles = t1 - t0;
}

extern "C" int fsem_chain(int which, int iters, float* out, long long* cycles) {
  void (*kernels[])(int, float, float*, long long*) = {
      chain_kernel<0>, chain_kernel<1>, chain_kernel<2>, chain_kernel<3>, chain_kernel<4>,
      chain_kernel<5>, chain_kernel<6>, chain_kernel<7>, chain_kernel<8>, chain_kernel<9>};
  kernels[which]<<<1, 32>>>(iters, 1.0001f, out, cycles);
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chain_latency: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    build = cuda_lib.PACKAGE_DIR / "_build_latency"
    build.mkdir(exist_ok=True)
    src, so = build / "chain.cu", build / "libchain.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(cuda_lib.CSRC_DIR), "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.fsem_chain.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    dev = torch.device("cuda", 0)
    out = torch.empty(32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    row = {}
    for which, name in enumerate(CHAINS):
        runs = []
        for iters in (ITERS, 2 * ITERS):  # the difference drops the loop's entry and exit
            assert lib.fsem_chain(which, iters, out.data_ptr(), cycles.data_ptr()) == 0
            torch.cuda.synchronize()
            runs.append(int(cycles.item()))
        row[name] = (runs[1] - runs[0]) / ITERS
    print(json.dumps({"cycles_per_iteration": row}), flush=True)


if __name__ == "__main__":
    main()
