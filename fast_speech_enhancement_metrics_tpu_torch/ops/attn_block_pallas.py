"""HuBERT post-LN encoder blocks: CUDA kernels A7 (attention) and A8 (FFN) and their plain versions.

Counterpart of the JAX package's ``ops/attn_block_pallas.py``:

* ``attn_block`` (A7, ``_attn_block_kernel``):
  y = LN(x + W_o · attn(x · W_qkv + b_qkv) + b_o) over (rows, T, d);
* ``ffn_block`` (A8, ``_ffn_block_kernel``):
  y = LN(x + W_2 · gelu(W_1 · x + b_1) + b_2).

Both are the default-precision class: x rounded to bf16 at entry (the
residual adds that rounded x), bf16 operands with fp32 accumulation, qkv,
the probabilities, the normalised context and the FFN hidden rounded to
bf16, LayerNorm statistics in fp32, the output in x's dtype. The softmax
is ``"exp2"`` (max-free 2^s with log2 e folded into q, s clamped to
[-100, 60]), ``"exp2_bf16"`` (the JAX kernel's ``jnp.exp2`` of the clamped
logit rounded to bf16, which is bf16(exp(bf16(s * bf16(ln 2))))) or
``"exact"`` (exp(s - rowmax)). The plain versions emulate "bf16 operands,
fp32 accumulation" as float32 products of bf16-rounded values.

The CUDA kernels are ``csrc/attn_block.cu``; A7's attention is
``csrc/attention_core.cuh``, shared with A9, for any head width up to 128.
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.attention_core import (
    LOG2E,
    MAX_HEAD_DIM,
    SOFTMAX_MODES,
    round_bf16,
    softmax_p,
)

KERNEL_A7 = "attn_block"
KERNEL_A8 = "ffn_block"


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-valued operands, fp32 accumulation (exact products, fp32 sums)."""
    return torch.matmul(round_bf16(a), round_bf16(b))


def pack_attn_block_params(p: dict, num_heads: int, softmax: str) -> tuple:
    """Layer params (JAX layout, (in, out) weights) -> the block's operands:
    (wqkv (d, 3d) bf16 with columns [q | k | v], bqkv (3d,) fp32, wo (d, d)
    bf16, bo, ln scale, ln shift (d,) fp32).

    The attention scale, times log2 e for the exp2 modes, folds into the q
    columns and bias in fp32 before the weights round to bf16, as the JAX
    package's packing does; its head-pair interleave of the columns is a
    TPU lane-alignment device and is not kept.
    """
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    d = p["q_w"].shape[0]
    scaling = (d // num_heads) ** -0.5
    if softmax != "exact":
        scaling = scaling * LOG2E
    f32 = torch.float32
    wqkv = torch.cat([p["q_w"].to(f32) * scaling, p["k_w"].to(f32), p["v_w"].to(f32)], dim=1)
    bqkv = torch.cat([p["q_b"].to(f32) * scaling, p["k_b"].to(f32), p["v_b"].to(f32)])
    return (
        wqkv.to(torch.bfloat16).contiguous(),
        bqkv.contiguous(),
        p["o_w"].to(torch.bfloat16).contiguous(),
        p["o_b"].to(f32).contiguous(),
        p["ln1_s"].to(f32).contiguous(),
        p["ln1_b"].to(f32).contiguous(),
    )


def pack_ffn_block_params(p: dict) -> tuple:
    """Layer params -> (w1 (d, ffn) bf16, b1 fp32, w2 (ffn, d) bf16, b2, ln
    scale, ln shift fp32)."""
    f32 = torch.float32
    return (
        p["ff_w1"].to(torch.bfloat16).contiguous(),
        p["ff_b1"].to(f32).contiguous(),
        p["ff_w2"].to(torch.bfloat16).contiguous(),
        p["ff_b2"].to(f32).contiguous(),
        p["ln2_s"].to(f32).contiguous(),
        p["ln2_b"].to(f32).contiguous(),
    )


def _residual_ln(y: torch.Tensor, xb: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float):
    r = y + xb
    mean = torch.mean(r, dim=-1, keepdim=True)
    cen = r - mean
    var = torch.mean(cen * cen, dim=-1, keepdim=True)
    return cen * torch.rsqrt(var + eps) * s + b


def _attn_block_plain(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A7."""
    wqkv, bqkv, wo, bo, lns, lnb = packed
    b, t, d = x.shape
    hd = d // num_heads
    xb = round_bf16(x)
    qkv = round_bf16(_dot(xb, wqkv.float()) + bqkv)  # (b, t, 3d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, t, num_heads, hd).transpose(1, 2) for i in range(3))
    p = softmax_p(torch.matmul(q, k.transpose(-1, -2)), softmax)  # of the (b, h, t, t) fp32 logits
    l = torch.sum(p, dim=-1, keepdim=True)
    ctx = round_bf16(torch.matmul(round_bf16(p), v) / l)  # (b, h, t, hd)
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
    return _residual_ln(_dot(ctx, wo.float()) + bo, xb, lns, lnb, eps).to(x.dtype)


def _gelu(h: torch.Tensor, gelu: str) -> torch.Tensor:
    return torch.nn.functional.gelu(h, approximate="tanh" if gelu == "tanh" else "none")


def _ffn_block_plain(x: torch.Tensor, packed: tuple, eps: float, gelu: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A8 (either GELU)."""
    w1, b1, w2, b2, lns, lnb = packed
    xb = round_bf16(x)
    h = round_bf16(_gelu(_dot(xb, w1.float()) + b1, gelu))
    return _residual_ln(_dot(h, w2.float()) + b2, xb, lns, lnb, eps).to(x.dtype)


_IO_DTYPES = (torch.float32, torch.bfloat16)


def _check_block_input(x: torch.Tensor, packed: tuple) -> None:
    if x.dtype not in _IO_DTYPES or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous (rows, T, d) fp32 or bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")
    for i, t in enumerate(packed):
        want = torch.bfloat16 if i in (0, 2) else torch.float32
        cuda_lib.check_operand(t, f"packed[{i}]", x.device, want, t.dim())


def _attn_block_cuda(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    _check_block_input(x, packed)
    rows, t, d = x.shape
    if d % num_heads or d // num_heads > MAX_HEAD_DIM or d % 32:
        raise ValueError(f"the attention kernel needs heads of at most {MAX_HEAD_DIM} and d % 32 == 0, "
                         f"got d={d}, heads={num_heads}")
    if rows == 0 or t == 0:
        raise ValueError(f"need at least one row and one frame, got {tuple(x.shape)}")
    wqkv, bqkv, wo, bo, lns, lnb = packed
    dev = x.device
    m = rows * t
    qkv = torch.empty(m, 3 * d, device=dev, dtype=torch.bfloat16)
    ctx = torch.empty(m, d, device=dev, dtype=torch.bfloat16)
    y = torch.empty(m, d, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    bf = int(x.dtype == torch.bfloat16)
    cuda_lib.launch(
        KERNEL_A7, dev, x, wqkv, bqkv, wo, bo, lns, lnb, qkv, ctx, y, out,
        rows, t, d, num_heads, SOFTMAX_MODES.index(softmax), bf, eps,
    )
    cuda_lib.launch_counts[KERNEL_A7] += 1
    return out


def _ffn_block_cuda(x: torch.Tensor, packed: tuple, eps: float, gelu: str) -> torch.Tensor:
    _check_block_input(x, packed)
    if gelu != "tanh":
        raise ValueError(f"the FFN kernel is tanh-GELU only, got gelu={gelu!r}")
    rows, t, d = x.shape
    w1, b1, w2, b2, lns, lnb = packed
    ffn = w1.shape[1]
    if d % 32 or ffn % 32 or rows * t == 0:
        raise ValueError(f"the FFN kernel needs d, ffn % 32 == 0 and rows, got d={d}, ffn={ffn}, {tuple(x.shape)}")
    dev = x.device
    m = rows * t
    hidden = torch.empty(m, ffn, device=dev, dtype=torch.bfloat16)
    y = torch.empty(m, d, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    bf = int(x.dtype == torch.bfloat16)
    cuda_lib.launch(KERNEL_A8, dev, x, w1, b1, w2, b2, lns, lnb, hidden, y, out, m, d, ffn, bf, eps)
    cuda_lib.launch_counts[KERNEL_A8] += 1
    return out


def attn_block(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str = "exp2") -> torch.Tensor:
    """Kernel A7 wrapper: y = LN(x + attention(x)) over (rows, T, d), in x's
    dtype. ``packed`` is ``pack_attn_block_params(p, num_heads, softmax)``."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    if x.device.type == "cpu":
        return _attn_block_plain(x, packed, num_heads, eps, softmax)
    if x.device.type != "cuda":
        raise ValueError(f"no attention-block kernel for device {x.device}")
    return _attn_block_cuda(x, packed, num_heads, eps, softmax)


def ffn_block(x: torch.Tensor, packed: tuple, eps: float, gelu: str = "tanh") -> torch.Tensor:
    """Kernel A8 wrapper: y = LN(x + FFN(x)) over (rows, T, d), in x's dtype.
    ``packed`` is ``pack_ffn_block_params(p)``. The kernel is tanh-GELU only;
    the plain version also takes ``gelu="erf"``."""
    if x.device.type == "cpu":
        return _ffn_block_plain(x, packed, eps, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN-block kernel for device {x.device}")
    return _ffn_block_cuda(x, packed, eps, gelu)

