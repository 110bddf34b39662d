"""Batched Levinson-Durbin Toeplitz solve: CUDA kernel A5 and its plain version.

Counterpart of the JAX package's ``ops/levinson_pallas.py``
(``levinson_solve_fused``, variant ``"vpu"``). The CUDA kernel
(``csrc/levinson.cu``) runs the whole n - 1 step recursion in one block per
row with every carry in registers; the r0[0] normalization (with its zero
guard) happens inside the kernel. The plain version is
``ops/toeplitz.py::levinson_solve``: the same recursion as tensor ops.
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.toeplitz import levinson_solve

KERNEL = "levinson_solve"


def _levinson_solve_cuda(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dev = r0.device
    cuda_lib.check_operand(r0, "r0", dev, torch.float32, 2)
    cuda_lib.check_operand(b, "b", dev, torch.float32, 2)
    batch, n = r0.shape
    if n % 32 or not 32 <= n <= 1024:
        raise NotImplementedError(f"the Levinson kernel takes orders 32..1024 in steps of 32, got {n}")
    if batch == 0:
        raise ValueError("need at least one row")
    x = torch.empty_like(r0)
    cuda_lib.launch(KERNEL, dev, r0, b, x, batch, n)
    cuda_lib.launch_counts[KERNEL] += 1
    return x


def levinson_solve_fused(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel A5 wrapper: solve T(r0) x = b, r0, b (B, n) float32 -> x (B, n).

    CPU tensors take the plain version (``levinson_solve``); CUDA tensors
    launch the kernel (or raise); any other device raises.
    """
    assert r0.ndim == 2 and b.shape == r0.shape
    if r0.device.type == "cpu":
        return levinson_solve(r0, b)
    if r0.device.type != "cuda":
        raise ValueError(f"no Levinson kernel for device {r0.device}")
    return _levinson_solve_cuda(r0, b)
