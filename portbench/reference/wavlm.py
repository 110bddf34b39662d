"""Plain reference of SpeechBERTScore on WavLM: float32 PyTorch, TF32 off.

Follows Hugging Face ``WavLMModel`` (the architecture of
``microsoft/wavlm-large``, ``modeling_wavlm.py``) and the upstream
SpeechBERTScore: the strided conv feature encoder with a LayerNorm over the
channels after every conv (``feat_extract_norm="layer"``), the feature
projection's LayerNorm and product, the grouped positional conv with its
GELU added to the projection, then pre-LN layers: LN, multi-head attention
whose logits take the relative-position bias, residual, LN, GELU FFN,
residual. The bias of key j for query i is layer 0's table at the bucket of
j - i (``relative_buckets``: half the buckets a side, a quarter of them
exact offsets, the rest log-spaced up to ``max_bucket_distance`` and
saturated beyond); each layer gates it per (head, query) from its own normed
input u: 8 logits a head from u_h (hd, 8), summed in two groups of 4, a and
b their sigmoids, gate a (b c_h - 1) + 2. The hidden state after
``output_layer`` layers takes the encoder's final LayerNorm only after the
last of the published layers. F1 is the harmonic mean of the mean best
cosine similarity of each denoised frame over the clean frames (precision)
and of each clean frame over the denoised ones (recall). ``gelu`` (``"erf"``
or ``"tanh"``) is the GELU of the conv encoder and of the layers' FFN, as
the metric's configuration states it; the positional conv's is exact.

Departures from ``modeling_wavlm.py``, none of which changes the function:
the positional conv's weight norm comes folded into an effective weight, as
the parameter layout carries it; dropout is absent (inference); the gated
bias of each layer is added to the logits directly instead of through
``F.multi_head_attention_forward``'s mask argument; the layers run in
blocks of pairs (``scores``'s ``block``).

Parameters: the nested dict of the benchmark's weight maker (the layout of
a converted checkpoint): matmul weights (in, out), conv weights (K, in /
groups, out), per layer ``gate_w`` (hd, 8), ``gate_b`` (8,), ``gate_const``
(heads,), and ``rel_embed`` (num_buckets, heads). Nothing here imports the
program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.hubert import _gelu, _layer_norm, _linear, _t, f1, float32_exact, on_device  # noqa: F401


def features(params: dict, cfg: dict, audio: torch.Tensor, gelu: str = "erf") -> torch.Tensor:
    """(rows, samples) float32 audio -> (rows, frames, conv channels): the
    layer-norm conv feature encoder's output."""
    dev = audio.device
    x = audio[:, None, :]
    for i, layer in enumerate(params["feature_encoder"]):
        x = F.conv1d(x, _t(layer["w"], dev).permute(2, 1, 0), stride=cfg["conv_stride"][i])
        if "b" in layer:
            x = x + _t(layer["b"], dev)[:, None]
        x = _layer_norm(x.transpose(1, 2), layer["norm_scale"], layer["norm_bias"], cfg["layer_norm_eps"])
        x = _gelu(x, gelu).transpose(1, 2)
    return x.transpose(1, 2)


def relative_buckets(offsets: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF ``_relative_positions_bucket`` of key - query offsets."""
    half = num_buckets // 2
    out = (offsets > 0).long() * half
    distance = offsets.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(distance.float() / max_exact) / math.log(max_distance / max_exact)
                         * (half - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return out + torch.where(distance < max_exact, distance, large)


def position_bias(params: dict, cfg: dict, frames: int, device) -> torch.Tensor:
    """(heads, frames, frames): layer 0's table at the bucket of key - query."""
    pos = torch.arange(frames, device=device)
    buckets = relative_buckets(pos[None, :] - pos[:, None], cfg["num_buckets"], cfg["max_bucket_distance"])
    return _t(params["rel_embed"], device)[buckets].permute(2, 0, 1)


def hidden_state(params: dict, cfg: dict, audio: torch.Tensor, output_layer: int, gelu: str = "erf") -> torch.Tensor:
    """(rows, samples) float32 audio -> (rows, frames, hidden)."""
    dev = audio.device
    eps = cfg["layer_norm_eps"]
    x = features(params, cfg, audio, gelu)
    fp = params["feature_projection"]
    x = _linear(_layer_norm(x, fp["ln_s"], fp["ln_b"], eps), fp["w"], fp["b"])

    pc = params["pos_conv"]
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), _t(pc["w"], dev).permute(2, 1, 0), _t(pc["b"], dev),
                   padding=k // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)

    heads = cfg["num_attention_heads"]
    rows, frames, width = x.shape
    hd = width // heads
    bias = position_bias(params, cfg, frames, dev)
    for p in params["layers"][:output_layer]:
        u = _layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
        q, k_, v = (_linear(u, p[f"{n}_w"], p[f"{n}_b"]).reshape(rows, frames, heads, hd).transpose(1, 2)
                    for n in "qkv")
        proj = _linear(u.reshape(rows, frames, heads, hd).transpose(1, 2), p["gate_w"], p["gate_b"])
        gate_a, gate_b = torch.sigmoid(proj.reshape(rows, heads, frames, 2, 4).sum(-1)).unbind(-1)
        gate = gate_a * (gate_b * _t(p["gate_const"], dev)[None, :, None] - 1.0) + 2.0
        logits = (q @ k_.transpose(-1, -2)) / hd**0.5 + gate[..., None] * bias[None]
        ctx = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(rows, frames, width)
        x = x + _linear(ctx, p["o_w"], p["o_b"])
        h = _gelu(_linear(_layer_norm(x, p["ln2_s"], p["ln2_b"], eps), p["ff_w1"], p["ff_b1"]), gelu)
        x = x + _linear(h, p["ff_w2"], p["ff_b2"])
    if output_layer == cfg["num_hidden_layers"]:
        x = _layer_norm(x, params["encoder_ln"]["s"], params["encoder_ln"]["b"], eps)
    return x


def scores(params: dict, cfg: dict, clean: torch.Tensor, denoised: torch.Tensor, output_layer: int,
           block: int = 8, gelu: str = "erf") -> list[dict[str, float]]:
    """Per-pair ``{"SpeechBERTScore": F1}`` of (pairs, samples) audio of one
    length, ``block`` pairs at a time; ``params`` as ``on_device`` gives
    them on the audio's device."""
    out = []
    with float32_exact(), torch.inference_mode():
        for i in range(0, clean.shape[0], block):
            c, d = clean[i:i + block].float(), denoised[i:i + block].float()
            h = hidden_state(params, cfg, torch.cat([c, d]), output_layer, gelu)
            out += [{"SpeechBERTScore": float(v)} for v in f1(h[:c.shape[0]], h[c.shape[0]:]).cpu()]
    return out
