"""HuBERT post-LN encoder blocks: CUDA kernels A7, A8, A11, A12 and their plain versions.

Counterpart of the JAX package's ``ops/attn_block_pallas.py``:

* ``attn_block`` (A7, ``_attn_block_kernel``):
  y = LN(x + W_o · attn(x · W_qkv + b_qkv) + b_o) over (rows, T, d);
* ``ffn_block`` (A8, ``_ffn_block_kernel``):
  y = LN(x + W_2 · gelu(W_1 · x + b_1) + b_2);
* ``layer_block`` (A11, ``_layer_block_kernel``): A7 then A8, the
  intermediate crossing in x's dtype (on the card written once in bf16,
  which A8 rounds it to at entry anyway);
* ``attn_block(..., quant="int8")`` (A12, A7's kernel with ``_quant_rows``,
  ``_quant_cols`` and ``_dot_i8``): every product int8 x int8 -> int32,
  dynamic per-row activation scales and per-column weight scales
  (``_attn_block_int8_plain`` spells out the steps).

Both are the default-precision class: x rounded to bf16 at entry (the
residual adds that rounded x), bf16 operands with fp32 accumulation, qkv,
the probabilities, the normalised context and the FFN hidden rounded to
bf16, LayerNorm statistics in fp32, the output in x's dtype. The softmax
is ``"exp2"`` (max-free 2^s with log2 e folded into q, s clamped to
[-100, 60]), ``"exp2_bf16"`` (the JAX kernel's ``jnp.exp2`` of the clamped
logit rounded to bf16, which is bf16(exp(bf16(s * bf16(ln 2))))) or
``"exact"`` (exp(s - rowmax)). The plain versions emulate "bf16 operands,
fp32 accumulation" as float32 products of bf16-rounded values.

The CUDA kernels are ``csrc/attn_block.cu`` (A7, A8: the Hopper GEMM of
``csrc/gemm_sm90.cuh`` with fused epilogues, ``gemm`` here alone, and A7's
attention on ``csrc/flash_sm90.cuh``, A9's kernel, for any head width up
to 128), ``csrc/layer_block.cu`` (A11: A7's and A8's launches chained,
LN1 written straight to a bf16 h, so bit-equal to A7 then A8, at every
head width A7 takes) and ``csrc/attn_block_int8.cu`` (A12: the int8 arm
of the same GEMM, ``gemm_i8`` here alone, and an int8 attention on TMA
and int8 ``wgmma``). CPU tensors take the plain versions; CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, numerics
from fast_speech_enhancement_metrics_tpu_torch.ops.numerics import (
    LOG2E,
    MAX_HEAD_DIM,
    SOFTMAX_MODES,
    dot,
    layer_norm,
    round_bf16,
    softmax_p,
)

KERNEL_A7 = "attn_block"
KERNEL_A8 = "ffn_block"
KERNEL_A11 = "layer_block"
KERNEL_A12 = "attn_block_int8"
KERNEL_GEMM = "gemm"
KERNEL_GEMM_I8 = "gemm_i8"
#: epilogues of ``gemm``: bf16(acc + bias), bf16(gelu_tanh(acc + bias)), acc + bias in fp32
GEMM_EPILOGUES = ("bf16", "gelu_bf16", "f32")
QUANT_MODES = (None, "int8")


#: 1 / 127 rounded to fp32. Inside the JAX kernel XLA's algebraic
#: simplifier turns each division by the constant 127 into a product with
#: this reciprocal (on every backend), so A12's activation scales are
#: max|x| * INV_127, and its P V dequantization acc * INV_127; the weights,
#: quantized by the packing outside the kernel, keep the division.
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quant_rows(x: torch.Tensor, in_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis (JAX ``_quant_rows``):
    (int8 values as float, scale (..., 1)); s = max(max|x| / 127, 1e-12) (in
    the kernel, max|x| * INV_127), q = round-half-even(x / s)."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s = torch.clamp(amax * INV_127 if in_kernel else amax / 127.0, min=1e-12)
    return torch.round(x / s), s


def _quant_cols(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same over the second-to-last axis (JAX ``_quant_cols``) for the
    weights, outside the kernel: a scale per column, (..., 1, N)."""
    q, s = _quant_rows(x.transpose(-1, -2), in_kernel=False)
    return q.transpose(-1, -2), s.transpose(-1, -2)


def _dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of int8-valued operands, exact as the int32 accumulation of
    the kernels (float64 sums: past ~1040 terms of 127^2 float32 would
    round), then rounded to fp32 as JAX's int32 -> fp32 cast."""
    return torch.matmul(a.double(), b.double()).float()


def pack_attn_block_params(p: dict, num_heads: int, softmax: str, quant: str | None = None) -> tuple:
    """Layer params (JAX layout, (in, out) weights) -> the block's operands:
    (wqkv (d, 3d) bf16 with columns [q | k | v], bqkv (3d,) fp32, wo (d, d)
    bf16, bo, ln scale, ln shift (d,) fp32).

    The attention scale, times log2 e for the exp2 modes, folds into the q
    columns and bias in fp32 before the weights round to bf16, as the JAX
    package's packing does; its head-pair interleave of the columns is a
    TPU lane-alignment device and is not kept.

    ``quant="int8"`` (A12) quantizes the fp32 folded weights per column
    instead, as the JAX packing does, and gives (wqkv (3d, d) int8, bqkv
    (2, 3d) fp32 = [bias; column scales], wo (d, d) int8, bo (2, d) fp32,
    ln scale, ln shift): the int8 weights in (out, in) layout, the layout
    the kernel's int8 tensor-core operands take.
    """
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    d = p["q_w"].shape[0]
    scaling = (d // num_heads) ** -0.5
    if softmax != "exact":
        scaling = scaling * LOG2E
    f32 = torch.float32
    wqkv = torch.cat([p["q_w"].to(f32) * scaling, p["k_w"].to(f32), p["v_w"].to(f32)], dim=1)
    bqkv = torch.cat([p["q_b"].to(f32) * scaling, p["k_b"].to(f32), p["v_b"].to(f32)])
    if quant == "int8":
        wq, sq = _quant_cols(wqkv)
        woq, so = _quant_cols(p["o_w"].to(f32))
        return (
            wq.to(torch.int8).t().contiguous(),
            torch.stack([bqkv, sq[0]]).contiguous(),
            woq.to(torch.int8).t().contiguous(),
            torch.stack([p["o_b"].to(f32), so[0]]).contiguous(),
            p["ln1_s"].to(f32).contiguous(),
            p["ln1_b"].to(f32).contiguous(),
        )
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


def _attn_block_plain(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A7."""
    wqkv, bqkv, wo, bo, lns, lnb = packed
    b, t, d = x.shape
    hd = d // num_heads
    xb = round_bf16(x)
    qkv = round_bf16(dot(xb, wqkv.float()) + bqkv)  # (b, t, 3d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, t, num_heads, hd).transpose(1, 2) for i in range(3))
    p = softmax_p(torch.matmul(q, k.transpose(-1, -2)), softmax)  # of the (b, h, t, t) fp32 logits
    l = torch.sum(p, dim=-1, keepdim=True)
    ctx = round_bf16(torch.matmul(round_bf16(p), v) / l)  # (b, h, t, hd)
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
    return layer_norm(dot(ctx, wo.float()) + bo + xb, lns, lnb, eps).to(x.dtype)


def _v_scales(v: torch.Tensor, b_v: torch.Tensor, t: int) -> torch.Tensor:
    """A12's per-column v scales over the keys, (b, h, 1, hd). The JAX
    kernel pads T to a multiple of 8 with zero rows, whose qkv is the bias,
    so when T % 8 != 0 its padded keys' v = b_v counts in the column
    maximum; the port pads nothing and adds that term."""
    amax = torch.amax(torch.abs(v), dim=-2, keepdim=True)
    if t % 8:
        amax = torch.maximum(amax, torch.abs(b_v))
    return torch.clamp(amax * INV_127, min=1e-12)


def _attn_block_int8_plain(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A12 (JAX ``_attn_block_kernel`` with
    ``quant="int8"``), step by step:

    1. x rounded to bf16, quantized per row over d;
    2. qkv = (acc_i32 sx) sw + b in fp32 (not rounded to bf16);
    3. per head, q and k quantized per row over the head width, s =
       (qq kq^T)_i32 sq sk^T, the softmax mode as A7's, l = sum p in fp32;
    4. normalise first, pn = p / l, pq = round(127 pn); v quantized per
       column over the keys (``_v_scales``); ctx = ((pq vq)_i32 / 127) sv;
    each "/ 127" of the kernel as XLA compiles it, a product with INV_127;
    5. the context quantized per row over d (all heads); out = (cq
       wo_q)_i32 sc so + bo;
    6. residual and LayerNorm as A7, in x's dtype.
    """
    wq_t, bq2, wo_t, bo2, lns, lnb = packed
    b, t, d = x.shape
    hd = d // num_heads
    xb = round_bf16(x)
    xq, sx = _quant_rows(xb)
    qkv = _dot_i8(xq, wq_t.t().float()) * sx * bq2[1] + bq2[0]  # (b, t, 3d) fp32
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, t, num_heads, hd).transpose(1, 2) for i in range(3))
    qq, sq = _quant_rows(q)
    kq, sk = _quant_rows(k)
    p = softmax_p(_dot_i8(qq, kq.transpose(-1, -2)) * sq * sk.transpose(-1, -2), softmax)
    l = torch.sum(p, dim=-1, keepdim=True)
    pq = torch.round(p / l * 127.0)
    sv = _v_scales(v, bq2[0, 2 * d:].reshape(num_heads, 1, hd), t)
    ctx = _dot_i8(pq, torch.round(v / sv)) * INV_127 * sv  # (b, h, t, hd)
    cq, sc = _quant_rows(ctx.transpose(1, 2).reshape(b, t, d))
    out = _dot_i8(cq, wo_t.t().float()) * sc * bo2[1] + bo2[0]
    return layer_norm(out + xb, lns, lnb, eps).to(x.dtype)


def _ffn_block_plain(x: torch.Tensor, packed: tuple, eps: float, gelu: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A8 (either GELU)."""
    w1, b1, w2, b2, lns, lnb = packed
    xb = round_bf16(x)
    h = round_bf16(numerics.gelu(dot(xb, w1.float()) + b1, gelu))
    return layer_norm(dot(h, w2.float()) + b2 + xb, lns, lnb, eps).to(x.dtype)


_IO_DTYPES = (torch.float32, torch.bfloat16)


def _check_block_input(x: torch.Tensor, packed: tuple, weight_dtype: torch.dtype = torch.bfloat16) -> None:
    if x.dtype not in _IO_DTYPES or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous (rows, T, d) fp32 or bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")
    if x.data_ptr() % 16:  # the kernels read x in 16-byte vectors and through TMA
        raise ValueError(f"x: need a 16-byte aligned start, got a view at element offset {x.storage_offset()}")
    for i, t in enumerate(packed):
        want = weight_dtype if i in (0, 2) else torch.float32
        cuda_lib.check_operand(t, f"packed[{i}]", x.device, want, t.dim())


def _check_heads(d: int, num_heads: int) -> None:
    if d % num_heads or d // num_heads > MAX_HEAD_DIM or d % 32:
        raise ValueError(f"the attention kernels need heads of at most {MAX_HEAD_DIM} and d % 32 == 0, "
                         f"got d={d}, heads={num_heads}")


def _bf16_copy(x: torch.Tensor, m: int, d: int) -> torch.Tensor | None:
    """Scratch for the kernels' bf16 copy of an fp32 x; None for a bf16 x,
    which they read as it is."""
    return None if x.dtype == torch.bfloat16 else torch.empty(m, d, device=x.device, dtype=torch.bfloat16)


def _head_pad(x: torch.Tensor, rows: int, t: int, heads: int, hd: int) -> torch.Tensor | None:
    """Scratch for heads whose width is not a multiple of 8 (TMA's 16-byte
    strides): q, k, v and the context through zero-padded (rows, heads, T,
    hd8) copies; None for other widths."""
    if hd % 8 == 0:
        return None
    return torch.empty(4 * rows * heads * t * -(-hd // 8) * 8, device=x.device, dtype=torch.bfloat16)


def _attn_block_cuda(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    _check_block_input(x, packed)
    rows, t, d = x.shape
    _check_heads(d, num_heads)
    if rows == 0 or t == 0:
        raise ValueError(f"need at least one row and one frame, got {tuple(x.shape)}")
    wqkv, bqkv, wo, bo, lns, lnb = packed
    dev = x.device
    m = rows * t
    hd = d // num_heads
    qkv = torch.empty(m, 3 * d, device=dev, dtype=torch.bfloat16)
    ctx = torch.empty(m, d, device=dev, dtype=torch.bfloat16)
    y = torch.empty(m, d, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    bf = int(x.dtype == torch.bfloat16)
    cuda_lib.launch(
        KERNEL_A7, dev, x, wqkv, bqkv, wo, bo, lns, lnb, _bf16_copy(x, m, d), qkv, ctx, y,
        _head_pad(x, rows, t, num_heads, hd), out,
        rows, t, d, num_heads, SOFTMAX_MODES.index(softmax), bf, eps,
    )
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
    cuda_lib.launch(KERNEL_A8, dev, x, w1, b1, w2, b2, lns, lnb, _bf16_copy(x, m, d), hidden, y, out, m, d, ffn, bf,
                    eps)
    return out


def _gemm_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, epilogue: str) -> torch.Tensor:
    """Plain PyTorch version of the GEMM kernel of A7 and A8."""
    c = dot(a, b.float()) + bias
    if epilogue == "gelu_bf16":
        c = numerics.gelu(c, "tanh")
    return c if epilogue == "f32" else c.to(torch.bfloat16)


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, epilogue: str = "f32"):
    """The products of A7 and A8 alone: epilogue(a (M, K) b (K, N) + bias)
    with fp32 accumulation; ``epilogue`` one of ``GEMM_EPILOGUES`` (fp32
    out, or bf16 after the bias or the tanh GELU). a and b bf16, bias (N,)
    fp32; on the card K and N multiples of 8."""
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"epilogue must be one of {GEMM_EPILOGUES}, got {epilogue!r}")
    return cuda_lib.dispatch("GEMM kernel", a.device, _gemm_plain, _gemm_cuda, a, b, bias, epilogue)


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, epilogue: str) -> torch.Tensor:
    cuda_lib.check_operand(a, "a", a.device, torch.bfloat16, 2)
    cuda_lib.check_operand(b, "b", a.device, torch.bfloat16, 2)
    cuda_lib.check_operand(bias, "bias", a.device, torch.float32, 1)
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k or bias.shape[0] != n or m == 0 or k % 8 or n % 8:
        raise ValueError(f"the GEMM kernel needs (M, K) x (K, N) and K, N % 8 == 0, "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}, bias {tuple(bias.shape)}")
    c = torch.empty(m, n, device=a.device, dtype=torch.float32 if epilogue == "f32" else torch.bfloat16)
    cuda_lib.launch(KERNEL_GEMM, a.device, a, b, bias, c, m, n, k, GEMM_EPILOGUES.index(epilogue))
    return c


def _attn_block_int8_cuda(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str) -> torch.Tensor:
    _check_block_input(x, packed, torch.int8)
    rows, t, d = x.shape
    _check_heads(d, num_heads)
    if rows == 0 or t == 0:
        raise ValueError(f"need at least one row and one frame, got {tuple(x.shape)}")
    wq_t, bq2, wo_t, bo2, lns, lnb = packed
    dev = x.device
    m = rows * t
    hd = d // num_heads
    i8, f32 = torch.int8, torch.float32
    t16, t128, hd16 = -(-t // 16) * 16, -(-t // 128) * 128, -(-hd // 16) * 16
    xq = torch.empty(m, d, device=dev, dtype=i8)  # then the quantized context
    s_row = torch.empty(m, device=dev, dtype=f32)  # sx, then sc
    qkv = torch.empty(m, 3 * d, device=dev, dtype=f32)
    qk_q = torch.empty(2, rows, num_heads, t, hd16, device=dev, dtype=i8)  # q, k per head, zero-padded to 16
    # their scales, padded to a key tile; the kernel selects p = 0 for keys
    # past t and writes no query past t, so the padding is never used
    s_qk = torch.empty(2, rows, num_heads, t128, device=dev, dtype=f32)
    s_v = torch.empty(rows, d, device=dev, dtype=f32)
    vt = torch.empty(rows, num_heads, hd, t16, device=dev, dtype=i8)  # v transposed, keys contiguous
    ctx = torch.empty(m, d, device=dev, dtype=f32)
    y = torch.empty(m, d, device=dev, dtype=f32)
    out = torch.empty_like(x)
    bf = int(x.dtype == torch.bfloat16)
    cuda_lib.launch(
        KERNEL_A12, dev, x, wq_t, bq2, wo_t, bo2, lns, lnb, xq, s_row, qkv, qk_q, s_qk, s_v, vt, ctx, y, out,
        rows, t, d, num_heads, SOFTMAX_MODES.index(softmax), bf, eps,
    )
    return out


def _gemm_i8_plain(a: torch.Tensor, b_t: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of A12's int8 GEMM: ((a b_t^T)_i32 sa) sb + bias
    in fp32, as ``_attn_block_int8_plain`` spells its products."""
    return _dot_i8(a.float(), b_t.t().float()) * sa[:, None] * sb + bias


def gemm_i8(a: torch.Tensor, b_t: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, bias: torch.Tensor):
    """The int8 products of A12 alone: c (M, N) fp32 = ((a b_t^T)_i32 sa[m])
    sb[n] + bias[n], each step rounded to fp32 in that order. a (M, K) and
    b_t (N, K) int8 (the (out, in) layout of the int8 packing), sa (M,), sb
    and bias (N,) fp32; on the card K % 16 == 0 and N % 8 == 0."""
    return cuda_lib.dispatch("int8 GEMM kernel", a.device, _gemm_i8_plain, _gemm_i8_cuda, a, b_t, sa, sb, bias)


def _gemm_i8_cuda(a: torch.Tensor, b_t: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    for t_, what, dtype, ndim in ((a, "a", torch.int8, 2), (b_t, "b_t", torch.int8, 2), (sa, "sa", torch.float32, 1),
                                  (sb, "sb", torch.float32, 1), (bias, "bias", torch.float32, 1)):
        cuda_lib.check_operand(t_, what, a.device, dtype, ndim)
    m, k = a.shape
    n = b_t.shape[0]
    if b_t.shape[1] != k or sa.shape[0] != m or sb.shape[0] != n or bias.shape[0] != n or m == 0 or k % 16 or n % 8:
        raise ValueError(f"the int8 GEMM kernel needs (M, K) x (N, K)^T, K % 16 == 0 and N % 8 == 0, got "
                         f"{tuple(a.shape)} x {tuple(b_t.shape)}, sa {tuple(sa.shape)}, sb {tuple(sb.shape)}, "
                         f"bias {tuple(bias.shape)}")
    c = torch.empty(m, n, device=a.device, dtype=torch.float32)
    cuda_lib.launch(KERNEL_GEMM_I8, a.device, a, b_t, sa, sb, bias, c, m, n, k)
    return c


def attn_block(x: torch.Tensor, packed: tuple, num_heads: int, eps: float, softmax: str = "exp2",
               quant: str | None = None) -> torch.Tensor:
    """Kernel A7 (A12 with ``quant="int8"``) wrapper: y = LN(x + attention(x))
    over (rows, T, d), in x's dtype. ``packed`` is
    ``pack_attn_block_params(p, num_heads, softmax, quant)``."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    int8 = quant == "int8"
    return cuda_lib.dispatch("attention-block kernel", x.device, _attn_block_int8_plain if int8 else _attn_block_plain,
                             _attn_block_int8_cuda if int8 else _attn_block_cuda, x, packed, num_heads, eps, softmax)


def ffn_block(x: torch.Tensor, packed: tuple, eps: float, gelu: str = "tanh") -> torch.Tensor:
    """Kernel A8 wrapper: y = LN(x + FFN(x)) over (rows, T, d), in x's dtype.
    ``packed`` is ``pack_ffn_block_params(p)``. The kernel is tanh-GELU only;
    the plain version also takes ``gelu="erf"``."""
    return cuda_lib.dispatch("FFN-block kernel", x.device, _ffn_block_plain, _ffn_block_cuda, x, packed, eps, gelu)


def _layer_block_plain(x: torch.Tensor, attn_packed: tuple, ffn_packed: tuple, num_heads: int, eps: float,
                       softmax: str, gelu: str) -> torch.Tensor:
    """Plain PyTorch version of kernel A11: A7's plain version, then A8's,
    the intermediate in x's dtype (JAX ``_layer_block_kernel`` writes it to
    its x-typed output block)."""
    return _ffn_block_plain(_attn_block_plain(x, attn_packed, num_heads, eps, softmax), ffn_packed, eps, gelu)


def _layer_block_cuda(x: torch.Tensor, attn_packed: tuple, ffn_packed: tuple, num_heads: int, eps: float,
                      softmax: str, gelu: str) -> torch.Tensor:
    _check_block_input(x, attn_packed)
    _check_block_input(x, ffn_packed)
    if gelu != "tanh":
        raise ValueError(f"the layer kernel is tanh-GELU only, got gelu={gelu!r}")
    rows, t, d = x.shape
    _check_heads(d, num_heads)
    ffn = ffn_packed[0].shape[1]
    if ffn % 32 or rows == 0 or t == 0:
        raise ValueError(f"the layer kernel needs ffn % 32 == 0 and rows, got ffn={ffn}, {tuple(x.shape)}")
    dev = x.device
    m = rows * t
    bf = torch.bfloat16
    qkv = torch.empty(m, 3 * d, device=dev, dtype=bf)
    ctx = torch.empty(m, d, device=dev, dtype=bf)
    y = torch.empty(m, d, device=dev, dtype=torch.float32)
    h = torch.empty(m, d, device=dev, dtype=bf)  # LN1's output, bf16 whatever x's dtype
    hidden = torch.empty(m, ffn, device=dev, dtype=bf)
    out = torch.empty_like(x)
    cuda_lib.launch(
        KERNEL_A11, dev, x, *attn_packed, *ffn_packed, _bf16_copy(x, m, d), qkv, ctx, y, h, hidden,
        _head_pad(x, rows, t, num_heads, d // num_heads), out,
        rows, t, d, num_heads, ffn, SOFTMAX_MODES.index(softmax), int(x.dtype == bf), eps,
    )
    return out


def layer_block(x: torch.Tensor, attn_packed: tuple, ffn_packed: tuple, num_heads: int, eps: float,
                softmax: str = "exp2", gelu: str = "tanh") -> torch.Tensor:
    """Kernel A11 wrapper: one whole post-LN layer, ffn_block(attn_block(x))
    over (rows, T, d), in x's dtype. ``attn_packed`` is
    ``pack_attn_block_params(p, num_heads, softmax)``, ``ffn_packed``
    ``pack_ffn_block_params(p)``. The kernel is tanh-GELU only; the plain
    version also takes ``gelu="erf"``."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    return cuda_lib.dispatch("layer kernel", x.device, _layer_block_plain, _layer_block_cuda, x, attn_packed,
                             ffn_packed, num_heads, eps, softmax, gelu)
