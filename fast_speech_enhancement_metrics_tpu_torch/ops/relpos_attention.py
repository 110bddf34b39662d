"""WavLM's gated relative-position attention and its pre-LN layer: CUDA kernels and plain versions.

No kernel of the JAX package computes this: the JAX package has no WavLM.
WavLM (Hugging Face ``WavLMAttention``) adds to each attention logit a
position bias gated per query:

    s[h, i, j] = (q_i s_q) . k_j + g[h, i] B[h, j - i],
    B[h, o] = rel_embed[bucket(o), h]                    (layer 0's table),
    (a, b) = sigmoid(sum over groups of 4 of (u_h W_g + b_g)),
    g[h, i] = a (b c_h - 1) + 2,

with u = LN(x) the layer's normed input, ``W_g`` (hd, 8) and ``b_g`` (8,)
shared by the heads, ``c_h`` a constant per head, and ``bucket`` the
bidirectional log-spaced bucketing of ``relative_position_buckets``.

* ``relpos_attention`` (kernel ``relpos_attn``, ``csrc/relpos_attn.cu`` on
  ``csrc/flash_sm90.cuh``): the attention of one layer on a (rows, T, 3 d +
  G) bf16 product whose columns are [q | k | v | gate logits]: the sum over
  groups of 4 folded into a (hd, 2) weight, its two columns per head are G
  more output columns of the QKV product. The kernel adds g[i] B_h(j - i)
  to each logit in registers from a per-head vector over offsets
  (``offset_bias``, made once per call and T and shared by every layer), and
  never builds the (T, T) bias;
* ``prenorm_layer`` (the route ``"relpos_block"`` of ``models/hubert.py``):
  one whole pre-LN layer, x + W_o attn(LN1(x)) + b_o, then + FFN(LN2(.)),
  in three launches: ``prenorm_in`` (LN1 to bf16 and the QKV + gate product),
  ``relpos_attention``, ``prenorm_out`` (W_o, the residual add and LN2, the
  FFN products, the second residual add). The products are
  ``csrc/gemm_sm90.cuh``'s, with their bias / GELU epilogues.

The class is the post-LN block kernels' (A7, A8): bf16 operands with fp32
accumulation, the normed inputs, qkv with the gate logits, the
probabilities, the normalised context and the FFN hidden rounded to bf16;
LayerNorm statistics, the softmax, the gate and the residual stream in
fp32. The attention scale (and log2 e in the exp2 modes) is folded into the
q columns before they are rounded to bf16, and log2 e into the offset
vector. CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import math

import torch

from fast_speech_enhancement_metrics_tpu_torch import tracing
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

KERNEL = "relpos_attn"
KERNEL_IN = "prenorm_in"
KERNEL_OUT = "prenorm_out"
#: the kernel's key tile: the offset vector covers the keys and queries padded to it
KEY_TILE = 128
#: queries a block of the plain versions takes at once, so that no (T, T) bias is built whole
QUERY_BLOCK = 256


def relative_position_buckets(offsets: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF ``WavLMAttention._relative_positions_bucket`` of key - query
    offsets: half the buckets a side (positive offsets the upper half), the
    offsets under a quarter of them exact, the rest log-spaced up to
    ``max_distance`` and saturated past it."""
    half = num_buckets // 2
    buckets = (offsets > 0).long() * half
    distance = torch.abs(offsets)
    max_exact = half // 2
    large = torch.log(distance.float() / max_exact) / math.log(max_distance / max_exact) * (half - max_exact)
    large = torch.clamp((max_exact + large).long(), max=half - 1)
    return buckets + torch.where(distance < max_exact, distance, large)


def padded_frames(t: int) -> int:
    """T rounded up to the kernel's key tile: the offset vector's half-length."""
    return -(-t // KEY_TILE) * KEY_TILE


def offset_bias(rel_embed: torch.Tensor, t: int, num_buckets: int, max_distance: int,
                scale: float = 1.0) -> torch.Tensor:
    """(heads, 2 tp) float32, tp = ``padded_frames(t)``: entry [h, o + tp] is
    ``scale`` rel_embed[bucket(o), h] for the offsets o = -tp .. tp - 1, which
    cover every key - query offset of T frames padded to the key tile.
    ``scale``: log2 e where the softmax takes base-2 logits."""
    tp = padded_frames(t)
    offsets = torch.arange(-tp, tp, device=rel_embed.device)
    table = rel_embed.float() * scale if scale != 1.0 else rel_embed.float()
    return table[relative_position_buckets(offsets, num_buckets, max_distance)].t().contiguous()


def position_bias(vec: torch.Tensor, i0: int, i1: int, t: int) -> torch.Tensor:
    """(heads, i1 - i0, t): B[h, i, j] = vec[h, j - i + tp] for queries
    i0 .. i1 - 1 and every key."""
    tp = vec.shape[1] // 2
    idx = torch.arange(t, device=vec.device)[None, :] - torch.arange(i0, i1, device=vec.device)[:, None] + tp
    return vec[:, idx]


def gate(u: torch.Tensor, gate_w: torch.Tensor, gate_b: torch.Tensor, gate_const: torch.Tensor,
         heads: int) -> torch.Tensor:
    """(b, heads, t) gate of WavLM's position bias from the normed layer
    input u (b, t, d), as HF computes it: 8 logits a head from ``gate_w``
    (hd, 8) and ``gate_b``, summed in two groups of 4, a and b their
    sigmoids, g = a (b c_h - 1) + 2."""
    b, t, d = u.shape
    uh = u.reshape(b, t, heads, d // heads).transpose(1, 2)
    proj = torch.matmul(uh, gate_w.to(u.dtype)) + gate_b.to(u.dtype)
    ga, gb = torch.sigmoid(proj.float().reshape(b, heads, t, 2, 4).sum(-1)).unbind(-1)
    return ga * (gb * gate_const.float()[None, :, None] - 1.0) + 2.0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, vec: torch.Tensor,
                    softmax: str, bf16: bool = False) -> torch.Tensor:
    """softmax(q k^T + g[i] B[j - i]) v over (b, heads, t, hd), q already
    scaled (times log2 e, and ``vec`` too, for base-2 logits), in blocks of
    ``QUERY_BLOCK`` queries; ``softmax`` one of ``SOFTMAX_MODES`` (logits
    in fp32). ``bf16``: the kernel's class, the probabilities rounded to
    bf16 before P V and the context after the division. Counts the bytes
    of the gated bias it builds (``relpos_bias_bytes``)."""
    b, h, t, _ = q.shape
    out = []
    for i0 in range(0, t, QUERY_BLOCK):
        i1 = min(t, i0 + QUERY_BLOCK)
        bias = g[:, :, i0:i1, None] * position_bias(vec, i0, i1, t)[None]
        tracing.count("relpos_bias_bytes", bias.numel() * bias.element_size())
        s = torch.matmul(q[:, :, i0:i1].float(), k.float().transpose(-1, -2)) + bias
        p = softmax_p(s, softmax)
        l = torch.sum(p, dim=-1, keepdim=True)
        if bf16:
            out.append(round_bf16(torch.matmul(round_bf16(p), v.float()) / l))
        else:
            out.append(torch.matmul(p.to(v.dtype), v) / l.to(v.dtype))
    return torch.cat(out, dim=2)


def gate_columns(heads: int) -> int:
    """G: the gate logits' columns of the QKV product, two a head, padded to
    a multiple of 8 (the product's 16-byte row rule)."""
    return -(-2 * heads // 8) * 8


def pack_prenorm_layer(p: dict, heads: int, softmax: str) -> tuple:
    """One pre-LN WavLM layer's params (JAX layout, (in, out) weights) ->
    the route's operands: (wqkvg (d, 3 d + G) bf16 with columns [q | k | v |
    gate], bqkvg fp32, gate_const (heads,) fp32, wo bf16, bo, ln1 scale,
    ln1 shift, w1 bf16, b1, w2 bf16, b2, ln2 scale, ln2 shift fp32).

    The attention scale, times log2 e for the exp2 modes, folds into the q
    columns and bias in fp32 before the weights round to bf16 (as
    ``pack_attn_block_params``); the gate's groups of 4 fold into a (hd, 2)
    weight and bias, laid block-diagonally: head h's two columns read its
    own hd rows."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    f32, bf = torch.float32, torch.bfloat16
    d = p["q_w"].shape[0]
    hd = d // heads
    scaling = hd**-0.5 * (LOG2E if softmax != "exact" else 1.0)
    gw = p["gate_w"].to(f32).reshape(hd, 2, 4).sum(-1)
    gb = p["gate_b"].to(f32).reshape(2, 4).sum(-1)
    wg = torch.zeros(d, gate_columns(heads), dtype=f32, device=gw.device)
    wg[:, :2 * heads] = torch.block_diag(*[gw] * heads)
    bg = torch.zeros(gate_columns(heads), dtype=f32, device=gw.device)
    bg[:2 * heads] = gb.repeat(heads)
    wqkvg = torch.cat([p["q_w"].to(f32) * scaling, p["k_w"].to(f32), p["v_w"].to(f32), wg], dim=1)
    bqkvg = torch.cat([p["q_b"].to(f32) * scaling, p["k_b"].to(f32), p["v_b"].to(f32), bg])
    return (
        wqkvg.to(bf).contiguous(), bqkvg.contiguous(), p["gate_const"].to(f32).contiguous(),
        p["o_w"].to(bf).contiguous(), p["o_b"].to(f32).contiguous(),
        p["ln1_s"].to(f32).contiguous(), p["ln1_b"].to(f32).contiguous(),
        p["ff_w1"].to(bf).contiguous(), p["ff_b1"].to(f32).contiguous(),
        p["ff_w2"].to(bf).contiguous(), p["ff_b2"].to(f32).contiguous(),
        p["ln2_s"].to(f32).contiguous(), p["ln2_b"].to(f32).contiguous(),
    )


def _gate_of_logits(qkvg: torch.Tensor, d: int, heads: int, gate_const: torch.Tensor) -> torch.Tensor:
    """(b, heads, t) gate from the product's bf16 gate columns, in fp32."""
    b, t, _ = qkvg.shape
    logits = qkvg[..., 3 * d:3 * d + 2 * heads].float().reshape(b, t, heads, 2).permute(0, 2, 1, 3)
    ga, gb = torch.sigmoid(logits).unbind(-1)
    return ga * (gb * gate_const.float()[None, :, None] - 1.0) + 2.0


def _relpos_attention_plain(qkvg: torch.Tensor, gate_const: torch.Tensor, vec: torch.Tensor, heads: int,
                            softmax: str) -> torch.Tensor:
    b, t, n = qkvg.shape
    d = (n - gate_columns(heads)) // 3
    hd = d // heads
    q, k, v = (qkvg[..., i * d:(i + 1) * d].float().reshape(b, t, heads, hd).transpose(1, 2) for i in range(3))
    g = _gate_of_logits(qkvg, d, heads, gate_const)
    ctx = attention_plain(q, k, v, g, vec, softmax, bf16=True)
    return ctx.transpose(1, 2).reshape(b, t, d).to(torch.bfloat16)


def _exp2_bf16_tie_allowance(qkvg: torch.Tensor, gate_const: torch.Tensor, vec: torch.Tensor, heads: int,
                             want: torch.Tensor) -> torch.Tensor:
    """For the tests: how far two float32 evaluations of the ``exp2_bf16``
    mode may lie apart beyond round-off, as ``sdpa_pallas``'s allowance with
    the bias in the logit. The mode rounds each logit to bf16, a step
    function, so two float32 sums of one logit (the kernel's and the plain
    version's) that straddle a step give p one bf16 step apart. Per output
    element (rows, T, d): the sum over the keys whose logit lies within
    2^-20 (sum_i |q_i k_i| + |g B|) of a step of dp_k (|v_k| + |want|) / l,
    in float64, with dp_k p's jump across that interval; 0 in a row with no
    such key."""
    b, t, n = qkvg.shape
    d = (n - gate_columns(heads)) // 3
    hd = d // heads
    q, k, v = (qkvg[..., i * d:(i + 1) * d].double().reshape(b, t, heads, hd).transpose(1, 2) for i in range(3))
    g = _gate_of_logits(qkvg, d, heads, gate_const).double()
    w = want.double().reshape(b, t, heads, hd).transpose(1, 2).abs()
    out = []
    for i0 in range(0, t, QUERY_BLOCK):
        i1 = min(t, i0 + QUERY_BLOCK)
        bias = g[:, :, i0:i1, None] * position_bias(vec.double(), i0, i1, t)[None]
        s = torch.matmul(q[:, :, i0:i1], k.transpose(-1, -2)) + bias
        delta = 2.0**-20 * (torch.matmul(q[:, :, i0:i1].abs(), k.abs().transpose(-1, -2)) + bias.abs())
        p_lo, p_mid, p_hi = (softmax_p(x.float(), "exp2_bf16").double() for x in (s - delta, s, s + delta))
        dp = p_hi - p_lo
        l = torch.sum(p_mid, dim=-1, keepdim=True)
        out.append((torch.matmul(dp, v.abs()) + torch.sum(dp, dim=-1, keepdim=True) * w[:, :, i0:i1]) / l)
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, t, d)


def _check_heads(d: int, heads: int) -> None:
    hd = d // heads
    if d % heads or hd > MAX_HEAD_DIM or hd % 8 or d % 32 or d > 1280:
        raise ValueError(f"the relative-position kernels need heads of a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"d % 32 == 0 and d <= 1280, got d={d}, heads={heads}")


def relpos_attention(qkvg: torch.Tensor, gate_const: torch.Tensor, vec: torch.Tensor, heads: int,
                     softmax: str = "exp2") -> torch.Tensor:
    """Kernel ``relpos_attn`` wrapper: the gated relative-position attention
    of one layer. qkvg (rows, T, 3 d + G) bf16, columns [q | k | v | gate
    logits] as ``pack_prenorm_layer``'s product gives them (q pre-scaled);
    gate_const (heads,) fp32; vec the ``offset_bias`` of T (times log2 e in
    the exp2 modes). Returns the context (rows, T, d) bf16."""
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    return cuda_lib.dispatch("relative-position attention kernel", qkvg.device, _relpos_attention_plain,
                             _relpos_attention_cuda, qkvg, gate_const, vec, heads, softmax)


def _relpos_attention_cuda(qkvg: torch.Tensor, gate_const: torch.Tensor, vec: torch.Tensor, heads: int,
                           softmax: str) -> torch.Tensor:
    dev = qkvg.device
    cuda_lib.check_operand(qkvg, "qkvg", dev, torch.bfloat16, 3)
    cuda_lib.check_operand(gate_const, "gate_const", dev, torch.float32, 1)
    cuda_lib.check_operand(vec, "offset bias", dev, torch.float32, 2)
    rows, t, n = qkvg.shape
    d = (n - gate_columns(heads)) // 3
    _check_heads(d, heads)
    tp = vec.shape[1] // 2
    if rows * t == 0 or n != 3 * d + gate_columns(heads) or vec.shape[0] != heads or tp < padded_frames(t):
        raise ValueError(f"relative-position attention: qkvg {tuple(qkvg.shape)} with {heads} heads, offset "
                         f"bias {tuple(vec.shape)} for T = {t}")
    ctx = torch.empty(rows, t, d, device=dev, dtype=torch.bfloat16)
    cuda_lib.launch("relpos_attention", dev, qkvg, gate_const, vec, ctx, rows, t, d, heads, n, tp,
                    SOFTMAX_MODES.index(softmax), count=KERNEL)
    return ctx


def _prenorm_in_plain(x: torch.Tensor, packed: tuple, eps: float) -> torch.Tensor:
    wqkvg, bqkvg, _, _, _, ln1s, ln1b = packed[:7]
    return (dot(layer_norm(x.float(), ln1s, ln1b, eps), wqkvg.float()) + bqkvg).to(torch.bfloat16)


def _prenorm_out_plain(x: torch.Tensor, ctx: torch.Tensor, packed: tuple, eps: float, gelu: str) -> torch.Tensor:
    _, _, _, wo, bo, _, _, w1, b1, w2, b2, ln2s, ln2b = packed
    x1 = x.float() + (dot(ctx.float(), wo.float()) + bo)
    u = round_bf16(layer_norm(x1, ln2s, ln2b, eps))
    hidden = round_bf16(numerics.gelu(dot(u, w1.float()) + b1, gelu))
    return x1 + (dot(hidden, w2.float()) + b2)


def _check_packed(x: torch.Tensor, packed: tuple) -> None:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x: need a (rows, T, d) fp32 tensor, got {tuple(x.shape)} {x.dtype}")
    _check_heads(x.shape[2], packed[2].shape[0])
    for i, a in enumerate(packed):
        cuda_lib.check_operand(a, f"packed[{i}]", x.device, torch.bfloat16 if i in (0, 3, 7, 9) else torch.float32,
                               a.dim())
    if packed[7].shape[1] % 32 or x.numel() == 0:
        raise ValueError(f"the pre-LN layer kernels need ffn % 32 == 0 and rows, got ffn={packed[7].shape[1]}, "
                         f"{tuple(x.shape)}")


def prenorm_in(x: torch.Tensor, packed: tuple, eps: float) -> torch.Tensor:
    """Kernel ``prenorm_in``: LN1 of x (rows, T, d) fp32 to bf16, then the
    QKV + gate product: the (rows, T, 3 d + G) bf16 operand of
    ``relpos_attention``. CPU tensors take the plain version."""
    return cuda_lib.dispatch("pre-LN layer kernels", x.device, _prenorm_in_plain, _prenorm_in_cuda, x, packed, eps)


def _prenorm_in_cuda(x: torch.Tensor, packed: tuple, eps: float) -> torch.Tensor:
    x = x.contiguous()
    _check_packed(x, packed)
    wqkvg, bqkvg, _, _, _, ln1s, ln1b = packed[:7]
    rows, t, d = x.shape
    m, n = rows * t, wqkvg.shape[1]
    u = torch.empty(m, d, device=x.device, dtype=torch.bfloat16)  # LN1's output
    qkvg = torch.empty(rows, t, n, device=x.device, dtype=torch.bfloat16)
    cuda_lib.launch(KERNEL_IN, x.device, x, ln1s, ln1b, wqkvg, bqkvg, u, qkvg, m, d, n, eps)
    return qkvg


def prenorm_out(x: torch.Tensor, ctx: torch.Tensor, packed: tuple, eps: float, gelu: str = "tanh") -> torch.Tensor:
    """Kernel ``prenorm_out``: x1 = x + ctx W_o + b_o, then x1 + FFN(LN2(x1))
    with the tanh GELU; x (rows, T, d) fp32, ctx (rows, T, d) bf16 as
    ``relpos_attention`` gives it. The kernel's FFN is tanh-GELU only; the
    plain version (CPU tensors) also takes ``gelu="erf"``."""
    return cuda_lib.dispatch("pre-LN layer kernels", x.device, _prenorm_out_plain, _prenorm_out_cuda, x, ctx, packed,
                             eps, gelu)


def _prenorm_out_cuda(x: torch.Tensor, ctx: torch.Tensor, packed: tuple, eps: float, gelu: str) -> torch.Tensor:
    if gelu != "tanh":
        raise ValueError(f"the pre-LN layer's FFN kernel is tanh-GELU only, got gelu={gelu!r}")
    x = x.contiguous()
    _check_packed(x, packed)
    cuda_lib.check_operand(ctx, "ctx", x.device, torch.bfloat16, 3)
    if ctx.shape != x.shape:
        raise ValueError(f"ctx {tuple(ctx.shape)} is not x's shape {tuple(x.shape)}")
    _, _, _, wo, bo, _, _, w1, b1, w2, b2, ln2s, ln2b = packed
    rows, t, d = x.shape
    m, ffn, dev = rows * t, w1.shape[1], x.device
    y = torch.empty(m, d, device=dev, dtype=torch.float32)
    u = torch.empty(m, d, device=dev, dtype=torch.bfloat16)  # LN2's output
    hidden = torch.empty(m, ffn, device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    cuda_lib.launch(KERNEL_OUT, dev, x, ctx, wo, bo, ln2s, ln2b, w1, b1, w2, b2, y, u, hidden, out, m, d, ffn, eps)
    return out


def prenorm_layer(x: torch.Tensor, packed: tuple, vec: torch.Tensor, heads: int, eps: float,
                  softmax: str = "exp2", gelu: str = "tanh") -> torch.Tensor:
    """One pre-LN WavLM layer on the route's kernels: x (rows, T, d) fp32 ->
    the layer's output fp32, ``prenorm_in``, ``relpos_attention`` and
    ``prenorm_out`` in turn; ``packed`` is ``pack_prenorm_layer(p, heads,
    softmax)``, ``vec`` the ``offset_bias`` of T. The kernels' FFN is
    tanh-GELU only; the plain versions (CPU tensors) also take
    ``gelu="erf"``. A bf16 x runs the layer in fp32 and returns it rounded
    to bf16."""
    if x.dtype == torch.bfloat16:
        return prenorm_layer(x.float(), packed, vec, heads, eps, softmax, gelu).to(torch.bfloat16)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x: need a (rows, T, d) fp32 or bf16 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cuda" and gelu != "tanh":  # before any launch
        raise ValueError(f"the pre-LN layer's FFN kernel is tanh-GELU only, got gelu={gelu!r}")
    qkvg = prenorm_in(x, packed, eps)
    with tracing.span("fsem.hubert.relpos_attn"):
        ctx = relpos_attention(qkvg, packed[2], vec, heads, softmax)
    if x.device.type == "cuda":
        tracing.count("relpos_bias_bytes", 0)  # the kernel builds no bias
    del qkvg
    return prenorm_out(x, ctx, packed, eps, gelu)
