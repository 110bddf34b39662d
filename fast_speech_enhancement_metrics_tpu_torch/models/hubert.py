"""HuBERT speech encoder in PyTorch, with the post-LN layers on kernels A7 and A8.

Counterpart of the JAX package's ``models/hubert.py``. Architecture
contract: Hugging Face ``HubertModel`` (SpeechBERTScore's reference loads
``utter-project/mHuBERT-147``): a strided conv feature encoder (group-norm
variant), feature projection, a grouped positional conv (batch-norm
pre-affine for mHuBERT-147), and a post-LN transformer stack of which only
the first ``output_layer`` layers run.

Parameters come in the JAX package's pytree layout (``init_params``,
``utils/convert_hubert.py``; (in, out) matmul weights, (K, in/groups, out)
conv weights) and ``from_jax_params`` carries them into ``HubertEncoder``,
which holds the conv weights transposed once to PyTorch's (out, in/groups,
K). Every float32 conv runs with cuDNN's TF32 off and every float32 matmul
without TF32, on the card as on the CPU.

``attention_impl``: ``"einsum"`` (plain tensor ops, either softmax);
``"sdpa"``, ``"sdpa_exp2"``, ``"sdpa_exp2_bf16"`` (the attention itself on
kernel A9) and ``"flash"`` (on kernel A15), whose q, k, v go to the kernel
in bf16 at the default precision; ``"block"`` (post-LN only: each layer's
attention block is kernel A7, its FFN plain tensor ops),
``"block_ffn"`` (A7 and, with the tanh GELU or on the CPU, the FFN block on
kernel A8; on the card the erf GELU takes the plain FFN after A7, as the
JAX package does on the TPU, whose FFN kernel has no erf),
``"layer_block"`` (with the tanh GELU the whole layer on kernel A11, its
softmax "exp2" or else "exact", so "exp2_bf16" runs exact there, as in the
JAX package; with the erf GELU the ``"block_ffn"`` route) and
``"block_int8"`` (the int8 attention block, kernel A12, then the plain FFN).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_speech_enhancement_metrics_tpu_torch.ops import attn_block_pallas, sdpa_pallas


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The subset of HF ``HubertConfig`` that affects inference."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" | "layer"
    feat_proj_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5


#: mHuBERT-147 is HuBERT-base with a batch-norm positional conv
MHUBERT_147_CONFIG = HubertConfig()

#: attention paths whose attention is one kernel (A9, A15) over (B, H, T, D)
KERNEL_ATTENTION_IMPLS = ("sdpa", "sdpa_exp2", "sdpa_exp2_bf16", "flash")
#: post-LN paths whose attention block is a kernel: A7, A11 (the whole layer), A12 (int8)
BLOCK_IMPLS = ("block", "block_ffn", "layer_block", "block_int8")
ATTENTION_IMPLS = ("einsum",) + KERNEL_ATTENTION_IMPLS + BLOCK_IMPLS


def _conv_flags():
    """cuDNN on, TF32 off: float32 convs stay float32 on the card."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics, result in x's dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def _gelu(x: torch.Tensor, gelu: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if gelu == "tanh" else "none")


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(a, dtype=np.float32)), requires_grad=False)


class HubertEncoder(nn.Module):
    """The encoder's parameters in the port's layout, built by
    ``from_jax_params``; run it with ``hubert_hidden_state``. Packed block
    operands for kernels A7/A8 are made on first use and kept per layer,
    softmax mode and device."""

    def __init__(self, params: dict, config: HubertConfig = MHUBERT_147_CONFIG):
        super().__init__()
        self.config = config
        fe = []
        for layer in params["feature_encoder"]:
            d = {k: _param(v) for k, v in layer.items() if k != "w"}
            d["w"] = _param(np.transpose(np.asarray(layer["w"]), (2, 1, 0)))  # KIO -> OIK
            fe.append(nn.ParameterDict(d))
        self.feature_encoder = nn.ModuleList(fe)
        self.feature_projection = nn.ParameterDict({k: _param(v) for k, v in params["feature_projection"].items()})
        pos = {k: _param(v) for k, v in params["pos_conv"].items() if k != "w"}
        pos["w"] = _param(np.transpose(np.asarray(params["pos_conv"]["w"]), (2, 1, 0)))
        self.pos_conv = nn.ParameterDict(pos)
        self.encoder_ln = nn.ParameterDict({k: _param(v) for k, v in params["encoder_ln"].items()})
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _param(v) for k, v in layer.items()}) for layer in params["layers"]
        )
        self._packed: dict = {}

    def _apply(self, fn, recurse=True):
        self._packed.clear()  # packed operands follow the parameters' device
        return super()._apply(fn, recurse)

    def packed_blocks(self, i: int, softmax: str, quant: str | None = None) -> tuple:
        """(attention-block operands, A8 operands) of layer i; ``quant="int8"``
        gives A12's int8 attention operands."""
        p = self.layers[i]
        key = (i, softmax, quant, str(p["q_w"].device))
        hit = self._packed.get(key)
        if hit is None:
            heads = self.config.num_attention_heads
            hit = (
                attn_block_pallas.pack_attn_block_params(p, heads, softmax, quant),
                attn_block_pallas.pack_ffn_block_params(p),
            )
            self._packed[key] = hit
        return hit


def from_jax_params(params_np: dict, config: HubertConfig = MHUBERT_147_CONFIG) -> HubertEncoder:
    """The JAX package's parameter pytree (numpy-convertible leaves) -> a
    ``HubertEncoder`` on the CPU (move it with ``.to(device)``)."""
    return HubertEncoder(params_np, config)


def feature_encoder(enc: HubertEncoder, audio: torch.Tensor, gelu: str = "erf") -> torch.Tensor:
    """(B, T) raw audio -> (B, frames, conv_dim[-1]) conv features."""
    config = enc.config
    x = audio[:, None, :]  # (B, 1, T): channels first
    for i, layer in enumerate(enc.feature_encoder):
        with _conv_flags():
            x = F.conv1d(x, layer["w"].to(x.dtype), stride=config.conv_stride[i])
        if "b" in layer:
            x = x + layer["b"].to(x.dtype)[:, None]
        if config.feat_extract_norm == "group" and i == 0:
            # GroupNorm(groups == channels): per-channel norm over time, fp32
            # one-pass statistics
            xf = x.float()
            mean = torch.mean(xf, dim=2, keepdim=True)
            var = torch.clamp(torch.mean(xf * xf, dim=2, keepdim=True) - mean * mean, min=0.0)
            xf = (xf - mean) * torch.rsqrt(var + config.layer_norm_eps)
            x = (xf * layer["norm_scale"].float()[:, None] + layer["norm_bias"].float()[:, None]).to(x.dtype)
        elif config.feat_extract_norm == "layer":
            x = _layer_norm(x.transpose(1, 2), layer["norm_scale"], layer["norm_bias"],
                            config.layer_norm_eps).transpose(1, 2)
        x = _gelu(x, gelu)
    return x.transpose(1, 2)


def _attention(
    p, x: torch.Tensor, num_heads: int, softmax: str = "exact", impl: str = "einsum",
    bf16_kernel: bool = False,
) -> torch.Tensor:
    """Multi-head self-attention with the fused (d, 3d) QKV projection: plain
    tensor ops (``impl="einsum"``) or one attention kernel (``"sdpa*"``: A9,
    ``"flash"``: A15). ``bf16_kernel`` (the default precision) casts q, k, v
    to bf16 for the kernel and its context back, as the JAX package does."""
    b, t, d = x.shape
    hd = d // num_heads
    scaling = hd**-0.5
    dt = x.dtype

    def split(h):
        return h.reshape(b, t, num_heads, hd).transpose(1, 2)

    qkv_w = torch.cat([p["q_w"], p["k_w"], p["v_w"]], dim=1).to(dt)
    qkv_b = torch.cat([p["q_b"], p["k_b"], p["v_b"]]).to(dt)
    qkv = torch.matmul(x, qkv_w) + qkv_b
    q, k, v = split(qkv[..., :d]), split(qkv[..., d:2 * d]), split(qkv[..., 2 * d:])
    if impl in KERNEL_ATTENTION_IMPLS:
        if impl == "flash":  # the flash kernel's softmax is always the exact one
            kernel = sdpa_pallas.flash_sdpa
        else:
            # "sdpa" inherits "exact" / "exp2"; the other two force a mode
            mode = {"sdpa": softmax if softmax in ("exact", "exp2") else "exact",
                    "sdpa_exp2": "exp2", "sdpa_exp2_bf16": "exp2_bf16"}[impl]
            kernel = functools.partial(sdpa_pallas.sdpa, softmax=mode)
        if bf16_kernel:
            q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
        ctx = kernel(q, k, v, scaling).to(dt)
    elif impl == "einsum":
        if softmax == "exp2":
            # max-free softmax: log2(e) folded into the logit scale, unshifted
            # 2^s normalised, overflow-guarded by the clamp
            logits = torch.matmul(q * (scaling * 1.4426950408889634), k.transpose(-1, -2))
            pw = torch.exp2(torch.clamp(logits.float(), -100.0, 120.0))
            weights = (pw / torch.sum(pw, dim=-1, keepdim=True)).to(logits.dtype)
        else:  # "exact"; the einsum path has no bf16 exponential, as in the JAX package
            logits = torch.matmul(q * scaling, k.transpose(-1, -2))
            weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        ctx = torch.matmul(weights, v)
    else:
        raise ValueError(f"unknown attention impl: {impl!r}")
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
    return torch.matmul(ctx, p["o_w"].to(dt)) + p["o_b"].to(dt)


def _ffn(p, x: torch.Tensor, gelu: str) -> torch.Tensor:
    dt = x.dtype
    h = _gelu(torch.matmul(x, p["ff_w1"].to(dt)) + p["ff_b1"].to(dt), gelu)
    return torch.matmul(h, p["ff_w2"].to(dt)) + p["ff_b2"].to(dt)


def _encoder_layer(
    enc: HubertEncoder, i: int, x: torch.Tensor, attention_impl: str = "einsum",
    gelu: str = "erf", softmax: str = "exact", bf16_kernel: bool = False,
) -> torch.Tensor:
    config = enc.config
    p = enc.layers[i]
    eps = config.layer_norm_eps
    heads = config.num_attention_heads
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}")
    if config.do_stable_layer_norm:
        if attention_impl in BLOCK_IMPLS:
            raise ValueError(f"pre-LN layers have no block path, got {attention_impl!r}")
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
        x = x + _attention(p, h, heads, softmax, attention_impl, bf16_kernel)
        return x + _ffn(p, _layer_norm(x, p["ln2_s"], p["ln2_b"], eps), gelu)
    if attention_impl == "layer_block" and gelu == "tanh":
        mode = "exp2" if softmax == "exp2" else "exact"
        attn_ops, ffn_ops = enc.packed_blocks(i, mode)
        return attn_block_pallas.layer_block(x, attn_ops, ffn_ops, heads, eps, softmax=mode, gelu=gelu)
    if attention_impl == "layer_block":
        attention_impl = "block_ffn"  # erf GELU: A7, then A8 or the plain FFN, as in the JAX package
    if attention_impl in BLOCK_IMPLS:
        quant = "int8" if attention_impl == "block_int8" else None
        attn_ops, ffn_ops = enc.packed_blocks(i, softmax, quant)
        x = attn_block_pallas.attn_block(x, attn_ops, heads, eps, softmax=softmax, quant=quant)
        if attention_impl == "block_ffn" and (gelu == "tanh" or x.device.type == "cpu"):
            return attn_block_pallas.ffn_block(x, ffn_ops, eps, gelu=gelu)
    else:
        x = _layer_norm(x + _attention(p, x, heads, softmax, attention_impl, bf16_kernel),
                        p["ln1_s"], p["ln1_b"], eps)
    return _layer_norm(x + _ffn(p, x, gelu), p["ln2_s"], p["ln2_b"], eps)


def hubert_hidden_state(
    enc: HubertEncoder,
    audio: torch.Tensor,
    output_layer: int = 8,
    attention_impl: str = "einsum",
    act_dtype: torch.dtype | None = None,
    gelu: str = "erf",
    softmax: str = "exact",
    precision: str | None = "highest",
) -> torch.Tensor:
    """(B, T) audio -> (B, frames, hidden) == HF ``hidden_states[output_layer]``:
    the output of the first ``output_layer`` encoder layers (only those run).

    ``precision``: at ``None`` or ``"default"`` the attention kernels of the
    ``"sdpa*"`` and ``"flash"`` paths take q, k, v in bf16, as the JAX
    package feeds its kernels; at ``"highest"`` in the activation dtype.
    The plain tensor ops run in the activation dtype at either.

    ``act_dtype=torch.bfloat16`` runs the activation stream in bf16 (norm
    statistics and the softmax stay fp32); the result is then fp32.
    ``softmax``: ``"exact"``, ``"exp2"`` or ``"exp2_bf16"``; the einsum path
    runs the last as ``"exact"``, as the JAX package does.
    """
    config = enc.config
    dt = act_dtype or torch.float32
    x = feature_encoder(enc, audio.to(dt), gelu=gelu)

    fp = enc.feature_projection
    if config.feat_proj_layer_norm:
        x = _layer_norm(x, fp["ln_s"], fp["ln_b"], config.layer_norm_eps)
    x = torch.matmul(x, fp["w"].to(dt)) + fp["b"].to(dt)

    pc = enc.pos_conv
    pos_in = x
    if "bn_scale" in pc:
        pos_in = x * pc["bn_scale"].to(dt) + pc["bn_shift"].to(dt)
    with _conv_flags():
        pos = F.conv1d(
            pos_in.transpose(1, 2), pc["w"].to(dt),
            padding=config.num_conv_pos_embeddings // 2,
            groups=config.num_conv_pos_embedding_groups,
        ).transpose(1, 2)
    if config.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :-1, :]
    x = x + _gelu(pos + pc["b"].to(dt), "erf")  # exact GELU, always

    enc_ln = enc.encoder_ln
    if not config.do_stable_layer_norm:
        # post-LN stack: the encoder LayerNorm applies before the layers
        x = _layer_norm(x, enc_ln["s"], enc_ln["b"], config.layer_norm_eps)
    for i in range(min(output_layer, len(enc.layers))):
        x = _encoder_layer(enc, i, x, attention_impl, gelu=gelu, softmax=softmax,
                           bf16_kernel=precision in (None, "default"))
    if config.do_stable_layer_norm and output_layer == config.num_hidden_layers:
        # pre-LN stack: the encoder LayerNorm applies after the final layer
        x = _layer_norm(x, enc_ln["s"], enc_ln["b"], config.layer_norm_eps)
    return x.float() if act_dtype is not None else x


def init_params(generator: torch.Generator, config: HubertConfig = MHUBERT_147_CONFIG) -> dict:
    """Seeded random parameter pytree in the JAX package's layout (numpy
    float32 leaves; the shapes and scales of its ``init_params``, not its
    values), for runs that need no real weights."""

    def nxt(*shape, scale=0.02):
        return (torch.randn(shape, generator=generator) * scale).numpy()

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    d = config.hidden_size
    params: dict = {"feature_encoder": []}
    for i, out_c in enumerate(config.conv_dim):
        in_c = 1 if i == 0 else config.conv_dim[i - 1]
        layer = {"w": nxt(config.conv_kernel[i], in_c, out_c, scale=0.1)}
        if config.conv_bias:
            layer["b"] = zeros(out_c)
        if (config.feat_extract_norm == "group" and i == 0) or config.feat_extract_norm == "layer":
            layer["norm_scale"] = ones(out_c)
            layer["norm_bias"] = zeros(out_c)
        params["feature_encoder"].append(layer)
    params["feature_projection"] = {"w": nxt(config.conv_dim[-1], d), "b": zeros(d)}
    if config.feat_proj_layer_norm:
        params["feature_projection"]["ln_s"] = ones(config.conv_dim[-1])
        params["feature_projection"]["ln_b"] = zeros(config.conv_dim[-1])
    groups = config.num_conv_pos_embedding_groups
    params["pos_conv"] = {"w": nxt(config.num_conv_pos_embeddings, d // groups, d), "b": zeros(d)}
    params["encoder_ln"] = {"s": ones(d), "b": zeros(d)}
    params["layers"] = [
        {
            "q_w": nxt(d, d), "q_b": zeros(d),
            "k_w": nxt(d, d), "k_b": zeros(d),
            "v_w": nxt(d, d), "v_b": zeros(d),
            "o_w": nxt(d, d), "o_b": zeros(d),
            "ln1_s": ones(d), "ln1_b": zeros(d),
            "ff_w1": nxt(d, config.intermediate_size),
            "ff_b1": zeros(config.intermediate_size),
            "ff_w2": nxt(config.intermediate_size, d),
            "ff_b2": zeros(d),
            "ln2_s": ones(d), "ln2_b": zeros(d),
        }
        for _ in range(config.num_hidden_layers)
    ]
    return params
