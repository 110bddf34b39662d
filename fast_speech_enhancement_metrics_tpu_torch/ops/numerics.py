"""The numerics that the kernels' wrappers and the plain versions share.

* The softmax modes that A7 (``attn_block_pallas``) and A9 (``sdpa_pallas``)
  take, in the kernels' mode order (``csrc/flash_sm90.cuh``,
  ``csrc/flash_f32_sm90.cuh``), the widest head the kernels hold, and the
  bf16 roundings the plain versions use to follow the kernels.
* The float32 class (bf16x6), as the FE, PC, A1-A3 and A9 / A15 float32
  kernels compute it: a float32 tensor split into three bf16 pieces
  (``split3``) and each product the six piece products of order <= 2, small
  terms first (``PRODUCTS``).
* The plain steps of the default-precision class and of the encoders:
  ``dot`` (bf16 operands, float32 sums), the GELU by name, the float32
  LayerNorm, and cuDNN's flags for float32 convs (TF32 off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SOFTMAX_MODES = ("exp2", "exp2_bf16", "exact")  # kernel mode ids 0, 1, 2; the online softmax is 3
LOG2E = 1.4426950408889634
#: ln 2 rounded to bf16: ``jnp.exp2`` of a bf16 array is exp(bf16(x * ln 2))
#: with ln 2 and the product in bf16, and the exp2_bf16 mode inherits that
LN2_BF16 = 0.69140625
#: the attention kernels' widest head (A7, A9, A15; kMaxHead in the header)
MAX_HEAD_DIM = 128
#: the float32 class's six piece products of order <= 2, (piece of the
#: activation, piece of the weight), small terms first
PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to fp32."""
    return t.to(torch.bfloat16).float()


def exp2_bf16(s: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of a bf16 array: exp(bf16(x * bf16(ln 2))), rounded to bf16."""
    return round_bf16(torch.exp(round_bf16(round_bf16(s) * LN2_BF16)))


def softmax_p(s: torch.Tensor, softmax: str) -> torch.Tensor:
    """Unnormalised probabilities of fp32 logits in one of ``SOFTMAX_MODES``
    (the clamp to [-100, 60] only in the exp2 modes)."""
    if softmax == "exact":
        return torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    clamped = torch.clamp(s, -100.0, 60.0)
    return torch.exp2(clamped) if softmax == "exp2" else exp2_bf16(clamped)


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x's three bf16 pieces, rounded to nearest even: x0 = bf16(x), x1 =
    bf16(x - x0), x2 = bf16(x - x0 - x1), x taken in float32; each
    difference is exact in float32, and x0 + x1 + x2 == x."""
    x = x.float()
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return x0, x1, (r - x1.float()).to(torch.bfloat16)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-valued operands, fp32 accumulation (exact products, fp32 sums)."""
    return torch.matmul(round_bf16(a), round_bf16(b))


def gelu(x: torch.Tensor, name: str) -> torch.Tensor:
    """The GELU by name: ``"tanh"`` its tanh approximation, else the exact (erf) one."""
    return F.gelu(x, approximate="tanh" if name == "tanh" else "none")


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics, result in x's dtype.

    x - mean is formed twice and never held: on the encoders' widest
    activations (WavLM's conv encoder, 6.7 GB a row chunk) a held copy
    raises the peak memory by its size."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def conv_flags():
    """cuDNN on, TF32 off: float32 convs stay float32 on the card."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
