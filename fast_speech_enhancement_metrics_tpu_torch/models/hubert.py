"""HuBERT speech encoder in PyTorch, with the post-LN layers on kernels A7 and A8.

Counterpart of the JAX package's ``models/hubert.py``. Architecture
contract: Hugging Face ``HubertModel`` (SpeechBERTScore's reference loads
``utter-project/mHuBERT-147``): a strided conv feature encoder (group-norm
variant), feature projection, a grouped positional conv (batch-norm
pre-affine for mHuBERT-147), and a post-LN transformer stack of which only
the first ``output_layer`` layers run. With ``relative_position_bias`` the
same encoder is Hugging Face ``WavLMModel`` (``WAVLM_LARGE_CONFIG``: the
layer-norm conv encoder, pre-LN layers whose attention logits take layer
0's relative-position bias gated per query, ``ops/relpos_attention.py``);
the JAX package has no WavLM.

Parameters come in the JAX package's pytree layout (``init_params``,
``utils/convert_hubert.py``; (in, out) matmul weights, (K, in/groups, out)
conv weights) and ``from_jax_params`` carries them into ``HubertEncoder``,
which holds the conv weights transposed once to PyTorch's (out, in/groups,
K). Every float32 conv runs with cuDNN's TF32 off and every float32 matmul
without TF32, on the card as on the CPU, except these stages on the card
in float32: two on one kernel each in bf16x6 on the tensor cores (the
float32 class), their weights' bf16 pieces cached beside the block
operands, the feature encoder's convs 1-6, conv and GELU, with the
layer-norm encoder's LayerNorm between them (``ops/conv_gelu.py``), and
the positional conv with its BN affine, bias, GELU and residual
(``ops/pos_conv.py``); and the layer-norm encoder's conv 0, conv,
LayerNorm and GELU, on a direct float32 kernel.

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
``"block_int8"`` (the int8 attention block, kernel A12, then the plain FFN);
``"relpos_block"`` (pre-LN layers with the gated relative-position bias:
each layer on the ``relpos_attn`` kernel between two launches of products,
``ops/relpos_attention.py::prenorm_layer``). A relative-bias config takes
``"einsum"`` or ``"relpos_block"``: A9, A15 and the post-LN blocks carry no
position bias.

While a ``torch.profiler`` session records, the conv encoder, the stage from
the feature projection through the positional conv, and each layer are
spans (``tracing.py``), and so is each layer's gated relative-position
attention.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fast_speech_enhancement_metrics_tpu_torch import tracing
from fast_speech_enhancement_metrics_tpu_torch.ops import (
    attn_block_pallas,
    conv_gelu,
    numerics,
    pos_conv,
    relpos_attention,
    sdpa_pallas,
)
from fast_speech_enhancement_metrics_tpu_torch.ops.numerics import LOG2E


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
    #: WavLM: every layer's logits take layer 0's relative-position bias, gated per query
    relative_position_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800

    def __repr__(self) -> str:
        """The dataclass repr; a config without the relative-position bias
        leaves its three fields out, and so prints as the JAX package's."""
        shown = [f.name for f in dataclasses.fields(self)]
        if not self.relative_position_bias:
            shown = shown[:-3]
        return f"HubertConfig({', '.join(f'{n}={getattr(self, n)!r}' for n in shown)})"


#: mHuBERT-147 is HuBERT-base with a batch-norm positional conv
MHUBERT_147_CONFIG = HubertConfig()
#: microsoft/wavlm-large: layer-norm conv encoder, pre-LN layers, gated relative-position bias
WAVLM_LARGE_CONFIG = HubertConfig(
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
    feat_extract_norm="layer", do_stable_layer_norm=True, relative_position_bias=True,
)

#: attention paths whose attention is one kernel (A9, A15) over (B, H, T, D)
KERNEL_ATTENTION_IMPLS = ("sdpa", "sdpa_exp2", "sdpa_exp2_bf16", "flash")
#: post-LN paths whose attention block is a kernel: A7, A11 (the whole layer), A12 (int8)
BLOCK_IMPLS = ("block", "block_ffn", "layer_block", "block_int8")
#: the pre-LN layer with the gated relative-position bias on its kernels (WavLM)
RELPOS_IMPL = "relpos_block"
ATTENTION_IMPLS = ("einsum",) + KERNEL_ATTENTION_IMPLS + BLOCK_IMPLS + (RELPOS_IMPL,)


#: cuDNN's flags around every float32 conv (TF32 off), looked up at each use
_conv_flags = numerics.conv_flags


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(a, dtype=np.float32)), requires_grad=False)


class HubertEncoder(nn.Module):
    """The encoder's parameters in the port's layout, built by
    ``from_jax_params``; run it with ``hubert_hidden_state``. Packed block
    operands for kernels A7/A8 and the conv weights' pieces for
    ``conv_gelu`` and ``pos_conv`` are made on first use and kept per
    layer (and softmax mode) and device."""

    def __init__(self, params: dict, config: HubertConfig = MHUBERT_147_CONFIG):
        super().__init__()
        self.config = config
        fe = []
        for layer in params["feature_encoder"]:
            d = {k: _param(v) for k, v in layer.items() if k != "w"}
            d["w"] = _param(np.ascontiguousarray(np.transpose(np.asarray(layer["w"]), (2, 1, 0))))  # KIO -> OIK
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
        # WavLM: layer 0's bucket table (num_buckets, heads), which every layer's bias reads
        self.rel_embed = _param(params["rel_embed"]) if "rel_embed" in params else None
        self._packed: dict = {}

    def _apply(self, fn, recurse=True):
        self._packed.clear()  # packed operands follow the parameters' device
        return super()._apply(fn, recurse)

    def _cached(self, key: tuple, make):
        """``self._packed[key]``, made by ``make()`` on first use."""
        hit = self._packed.get(key)
        if hit is None:
            hit = self._packed[key] = make()
        return hit

    def packed_blocks(self, i: int, softmax: str, quant: str | None = None) -> tuple:
        """(attention-block operands, A8 operands) of layer i; ``quant="int8"``
        gives A12's int8 attention operands."""
        p = self.layers[i]
        return self._cached((i, softmax, quant, str(p["q_w"].device)), lambda: (
            attn_block_pallas.pack_attn_block_params(p, self.config.num_attention_heads, softmax, quant),
            attn_block_pallas.pack_ffn_block_params(p),
        ))

    def packed_prenorm(self, i: int, softmax: str) -> tuple:
        """Layer i's operands of the pre-LN relative-position route
        (``relpos_attention.pack_prenorm_layer``)."""
        p = self.layers[i]
        return self._cached(("prenorm", i, softmax, str(p["q_w"].device)),
                            lambda: relpos_attention.pack_prenorm_layer(p, self.config.num_attention_heads, softmax))

    def conv_pieces(self, i: int) -> torch.Tensor:
        """The three bf16 pieces of conv layer i's weights, as the conv_gelu
        kernel reads them (``conv_gelu.split_pieces``)."""
        w = self.feature_encoder[i]["w"]
        return self._cached(("conv", i, str(w.device)), lambda: conv_gelu.split_pieces(w))

    def pos_pieces(self) -> torch.Tensor:
        """The three bf16 pieces of the positional conv's weights, as the
        pos_conv kernel reads them (``pos_conv.split_pieces``)."""
        w = self.pos_conv["w"]
        return self._cached(("pos", str(w.device)),
                            lambda: pos_conv.split_pieces(w, self.config.num_conv_pos_embedding_groups))


def from_jax_params(params_np: dict, config: HubertConfig = MHUBERT_147_CONFIG) -> HubertEncoder:
    """The JAX package's parameter pytree (numpy-convertible leaves) -> a
    ``HubertEncoder`` on the CPU (move it with ``.to(device)``)."""
    return HubertEncoder(params_np, config)


def feature_encoder(enc: HubertEncoder, audio: torch.Tensor, gelu: str = "erf") -> torch.Tensor:
    """(B, T) raw audio -> (B, frames, conv_dim[-1]) conv features.

    A layer with no bias runs as one kernel where its shape fits (on the
    card in float32): with no norm, conv and GELU (``conv_gelu.engages``:
    convs 1-6 of the group-norm encoder); in the layer-norm encoder, conv,
    LayerNorm and GELU (``conv_gelu.engages_ln``: convs 1-6;
    ``conv_gelu.engages_conv0_ln``: conv 0). Every other layer, and every
    layer on the CPU, takes ``F.conv1d`` and its passes."""
    with tracing.span("fsem.hubert.conv_encoder"):
        config = enc.config
        x = audio[:, None, :]  # (B, 1, T): channels first
        for i, layer in enumerate(enc.feature_encoder):
            layer_norm = config.feat_extract_norm == "layer"
            normed = (config.feat_extract_norm == "group" and i == 0) or layer_norm
            c_out, c_in, width = layer["w"].shape
            shape = (x.device.type, x.dtype, config.conv_stride[i], width, c_in, c_out)
            if "b" not in layer and not normed and conv_gelu.engages(*shape):
                x = conv_gelu.conv_gelu(x, layer["w"], gelu, pieces=enc.conv_pieces(i))
                continue
            if "b" not in layer and layer_norm and "norm_scale" in layer:
                norm = (layer["norm_scale"], layer["norm_bias"], config.layer_norm_eps, gelu)
                if conv_gelu.engages_ln(*shape):
                    x = conv_gelu.conv_ln_gelu(x, layer["w"], *norm, pieces=enc.conv_pieces(i))
                    continue
                if conv_gelu.engages_conv0_ln(*shape):
                    x = conv_gelu.conv0_ln_gelu(x, layer["w"], *norm)
                    continue
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
                x = numerics.layer_norm(x.transpose(1, 2), layer["norm_scale"], layer["norm_bias"],
                                        config.layer_norm_eps).transpose(1, 2)
            x = numerics.gelu(x, gelu)
        return x.transpose(1, 2)


def _attention(
    p, x: torch.Tensor, num_heads: int, softmax: str = "exact", impl: str = "einsum",
    bf16_kernel: bool = False, tp_group=None, rel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head self-attention: plain tensor ops (``impl="einsum"``) or one
    attention kernel (``"sdpa*"``: A9, ``"flash"``: A15). ``bf16_kernel``
    (the default precision) casts q, k, v to bf16 for the kernel and its
    context back, as the JAX package does.

    ``rel``: WavLM's offset vector (``relpos_attention.offset_bias``, times
    log2 e for the exp2 softmax); the logits then take the position bias,
    gated per query from x (the layer's normed input), in blocks of
    queries (plain tensor ops only).

    One device takes the fused (d, 3d) QKV projection. Under tensor
    parallelism (``tp_group``) ``p`` holds this rank's columns of q/k/v and
    rows of o (``parallel/sharding.py``): q, k and v are projected
    separately onto the local heads, of the full model's head width, and
    the output projection's partial sums are all-reduced over the group
    before ``o_b`` is added once."""
    b, t, d = x.shape
    hd = d // num_heads
    scaling = hd**-0.5
    dt = x.dtype
    local_d = p["q_w"].shape[1]

    def split(h):
        return h.reshape(b, t, local_d // hd, hd).transpose(1, 2)

    if tp_group is None:
        qkv_w = torch.cat([p["q_w"], p["k_w"], p["v_w"]], dim=1).to(dt)
        qkv_b = torch.cat([p["q_b"], p["k_b"], p["v_b"]]).to(dt)
        qkv = torch.matmul(x, qkv_w) + qkv_b
        q, k, v = split(qkv[..., :d]), split(qkv[..., d:2 * d]), split(qkv[..., 2 * d:])
    else:
        q, k, v = (split(torch.matmul(x, p[f"{n}_w"].to(dt)) + p[f"{n}_b"].to(dt)) for n in "qkv")
    if rel is not None:
        with tracing.span("fsem.hubert.relpos_attn"):
            g = relpos_attention.gate(x, p["gate_w"], p["gate_b"], p["gate_const"], num_heads)
            scale = scaling * LOG2E if softmax == "exp2" else scaling
            ctx = relpos_attention.attention_plain(q * scale, k, v, g, rel,
                                                   "exp2" if softmax == "exp2" else "exact")
    elif impl in KERNEL_ATTENTION_IMPLS:
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
    ctx = ctx.transpose(1, 2).reshape(b, t, local_d)
    return _row_sharded(ctx, p["o_w"], p["o_b"], tp_group)


def _row_sharded(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, tp_group) -> torch.Tensor:
    """h @ w + bias, where under ``tp_group`` h and w hold this rank's part
    of the reduced axis: the partial products are all-reduced first."""
    dt = h.dtype
    out = torch.matmul(h, w.to(dt))
    if tp_group is not None:
        dist.all_reduce(out, group=tp_group)
    return out + bias.to(dt)


def _ffn(p, x: torch.Tensor, gelu: str, tp_group=None) -> torch.Tensor:
    """The FFN; under ``tp_group``, this rank's ``ff_w1`` columns and
    ``ff_w2`` rows, all-reduced before ``ff_b2``."""
    dt = x.dtype
    h = numerics.gelu(torch.matmul(x, p["ff_w1"].to(dt)) + p["ff_b1"].to(dt), gelu)
    return _row_sharded(h, p["ff_w2"], p["ff_b2"], tp_group)


def _encoder_layer(
    enc: HubertEncoder, i: int, x: torch.Tensor, attention_impl: str = "einsum",
    gelu: str = "erf", softmax: str = "exact", bf16_kernel: bool = False, tp_group=None,
    rel: torch.Tensor | None = None,
) -> torch.Tensor:
    config = enc.config
    p = enc.layers[i]
    eps = config.layer_norm_eps
    heads = config.num_attention_heads
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}")
    if tp_group is not None and attention_impl in BLOCK_IMPLS + (RELPOS_IMPL,):
        raise ValueError(f"the block paths fuse the sharded products; under tensor parallelism take "
                         f"'einsum', 'sdpa*' or 'flash', got {attention_impl!r}")
    if (attention_impl == RELPOS_IMPL and rel is None) or (rel is not None and attention_impl not in (
            "einsum", RELPOS_IMPL)) or (rel is not None and tp_group is not None):
        raise ValueError(f"'{RELPOS_IMPL}' is the route of relative-bias configs, which take it or 'einsum' on one "
                         f"device; got {attention_impl!r} (relative_position_bias={config.relative_position_bias}"
                         f"{', under tensor parallelism' if tp_group is not None else ''})")
    if config.do_stable_layer_norm:
        if attention_impl == RELPOS_IMPL:
            return relpos_attention.prenorm_layer(x, enc.packed_prenorm(i, softmax), rel, heads, eps, softmax, gelu)
        if attention_impl in BLOCK_IMPLS:
            raise ValueError(f"pre-LN layers have no block path, got {attention_impl!r}")
        h = numerics.layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
        x = x + _attention(p, h, heads, softmax, attention_impl, bf16_kernel, tp_group, rel)
        return x + _ffn(p, numerics.layer_norm(x, p["ln2_s"], p["ln2_b"], eps), gelu, tp_group)
    if rel is not None:
        raise ValueError("the relative-position bias is WavLM's, whose layers are pre-LN")
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
        x = numerics.layer_norm(x + _attention(p, x, heads, softmax, attention_impl, bf16_kernel, tp_group),
                                p["ln1_s"], p["ln1_b"], eps)
    return numerics.layer_norm(x + _ffn(p, x, gelu, tp_group), p["ln2_s"], p["ln2_b"], eps)


def hubert_hidden_state(
    enc: HubertEncoder,
    audio: torch.Tensor,
    output_layer: int = 8,
    attention_impl: str = "einsum",
    act_dtype: torch.dtype | None = None,
    gelu: str = "erf",
    softmax: str = "exact",
    precision: str | None = "highest",
    tp_group=None,
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

    ``tp_group``: the ``model`` group of a tensor-parallel mesh, whose
    ranks hold their shards of the layers' products (``enc`` built from
    ``parallel.shard_params``); the conv feature encoder, the positional
    conv and the LayerNorms are replicated.
    """
    config = enc.config
    dt = act_dtype or torch.float32
    x = feature_encoder(enc, audio.to(dt), gelu=gelu)

    with tracing.span("fsem.hubert.pos_conv"):
        fp = enc.feature_projection
        if config.feat_proj_layer_norm:
            x = numerics.layer_norm(x, fp["ln_s"], fp["ln_b"], config.layer_norm_eps)
        x = torch.matmul(x, fp["w"].to(dt)) + fp["b"].to(dt)

        # x + gelu(conv(bn(x)) + b), exact GELU, always: on the card in
        # float32 one kernel where pos_conv.engages, else the plain steps
        pc = enc.pos_conv
        groups = config.num_conv_pos_embedding_groups
        bn = (pc["bn_scale"], pc["bn_shift"]) if "bn_scale" in pc else (None, None)
        if pos_conv.engages(x.device.type, x.dtype, pos_conv.STRIDE, pc["w"].shape[2], x.shape[2], groups):
            x = pos_conv.pos_conv(x, pc["w"], pc["b"], groups, *bn, pieces=enc.pos_pieces())
        else:
            x = pos_conv._pos_conv_plain(x, pc["w"], pc["b"], groups, *bn)

        enc_ln = enc.encoder_ln
        if not config.do_stable_layer_norm:
            # post-LN stack: the encoder LayerNorm applies before the layers
            x = numerics.layer_norm(x, enc_ln["s"], enc_ln["b"], config.layer_norm_eps)
    rel = None
    if config.relative_position_bias:
        # WavLM: the offset vector of layer 0's bucket table, made once for
        # this T and read by every layer; base-2 logits take it times log2 e
        base2 = softmax == "exp2" or (attention_impl == RELPOS_IMPL and softmax == "exp2_bf16")
        rel = relpos_attention.offset_bias(enc.rel_embed, x.shape[1], config.num_buckets,
                                           config.max_bucket_distance, LOG2E if base2 else 1.0)
    for i in range(min(output_layer, len(enc.layers))):
        with tracing.span("fsem.hubert.layer"):
            x = _encoder_layer(enc, i, x, attention_impl, gelu=gelu, softmax=softmax,
                               bf16_kernel=precision in (None, "default"), tp_group=tp_group, rel=rel)
    if config.do_stable_layer_norm and output_layer == config.num_hidden_layers:
        # pre-LN stack: the encoder LayerNorm applies after the final layer
        x = numerics.layer_norm(x, enc_ln["s"], enc_ln["b"], config.layer_norm_eps)
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
    if config.relative_position_bias:
        heads = config.num_attention_heads
        for layer in params["layers"]:
            layer.update(gate_w=nxt(d // heads, 8, scale=d**-0.5), gate_b=zeros(8), gate_const=ones(heads))
        params["rel_embed"] = nxt(config.num_buckets, heads, scale=1.0)
    return params
