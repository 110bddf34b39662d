"""Softmax numerics shared by the attention kernels' plain versions and wrappers.

The softmax modes that A7 (``attn_block_pallas``) and A9 (``sdpa_pallas``)
take, in the kernels' mode order (``csrc/flash_sm90.cuh``,
``csrc/flash_f32_sm90.cuh``), the widest head the kernels hold, and the
bf16 roundings the plain versions use to follow the kernels.
"""

from __future__ import annotations

import torch

SOFTMAX_MODES = ("exp2", "exp2_bf16", "exact")  # kernel mode ids 0, 1, 2; the online softmax is 3
LOG2E = 1.4426950408889634
#: ln 2 rounded to bf16: ``jnp.exp2`` of a bf16 array is exp(bf16(x * ln 2))
#: with ln 2 and the product in bf16, and the exp2_bf16 mode inherits that
LN2_BF16 = 0.69140625
#: the attention kernels' widest head (A7, A9, A15; kMaxHead in the header)
MAX_HEAD_DIM = 128


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
