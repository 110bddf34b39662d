"""Plain reference of SpeechBERTScore on HuBERT: float32 PyTorch, TF32 off.

Follows Hugging Face ``HubertModel`` (the architecture of
``utter-project/mHuBERT-147``) and the upstream SpeechBERTScore: the
strided conv feature encoder (GroupNorm after conv 0, exact GELU), the
feature projection's LayerNorm and product, the grouped positional conv
(its batch norm before it), the encoder LayerNorm, then post-LN layers
(softmax attention, residual, LayerNorm, GELU FFN, residual, LayerNorm);
the hidden state after ``output_layer`` layers. F1 is the harmonic mean of
the mean best cosine similarity of each denoised frame over the clean
frames (precision) and of each clean frame over the denoised ones (recall).
``gelu`` (``"erf"`` or ``"tanh"``) is the GELU of the conv encoder and of
the layers' FFN, as the metric's configuration states it; the positional
conv's is exact.

Departures from the published description, none of which changes the
function: the positional conv's weight norm and its inference-time batch
norm come folded (an effective weight, a per-channel scale and shift), as
the parameter layout below carries them; dropout is absent (inference).

Parameters: the nested dict of the benchmark's weight maker (the layout of
a converted checkpoint): matmul weights (in, out), conv weights (K, in /
groups, out). Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def on_device(tree, device):
    """The parameter tree with every leaf a float32 tensor on ``device``
    (done once, before many calls of ``scores``)."""
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [on_device(v, device) for v in tree]
    return _t(tree, device)


def _linear(x: torch.Tensor, w, b) -> torch.Tensor:
    return x @ _t(w, x.device) + _t(b, x.device)


def _layer_norm(x: torch.Tensor, s, b, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), _t(s, x.device), _t(b, x.device), eps)


def _gelu(x: torch.Tensor, gelu: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if gelu == "tanh" else "none")


def features(params: dict, cfg: dict, audio: torch.Tensor, gelu: str = "erf") -> torch.Tensor:
    """(rows, samples) float32 audio -> (rows, frames, conv channels): the
    conv feature encoder's output."""
    dev = audio.device
    x = audio[:, None, :]
    for i, layer in enumerate(params["feature_encoder"]):
        x = F.conv1d(x, _t(layer["w"], dev).permute(2, 1, 0), stride=cfg["conv_stride"][i])
        if "b" in layer:
            x = x + _t(layer["b"], dev)[:, None]
        if cfg["feat_extract_norm"] == "group" and i == 0:
            x = F.group_norm(x, x.shape[1], _t(layer["norm_scale"], dev), _t(layer["norm_bias"], dev),
                             cfg["layer_norm_eps"])
        x = _gelu(x, gelu)
    return x.transpose(1, 2)


def hidden_state(params: dict, cfg: dict, audio: torch.Tensor, output_layer: int, gelu: str = "erf") -> torch.Tensor:
    """(rows, samples) float32 audio -> (rows, frames, hidden)."""
    dev = audio.device
    eps = cfg["layer_norm_eps"]
    x = features(params, cfg, audio, gelu)
    fp = params["feature_projection"]
    if cfg["feat_proj_layer_norm"]:
        x = _layer_norm(x, fp["ln_s"], fp["ln_b"], eps)
    x = _linear(x, fp["w"], fp["b"])

    pc = params["pos_conv"]
    pos_in = x * _t(pc["bn_scale"], dev) + _t(pc["bn_shift"], dev) if "bn_scale" in pc else x
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(pos_in.transpose(1, 2), _t(pc["w"], dev).permute(2, 1, 0), _t(pc["b"], dev),
                   padding=k // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    x = _layer_norm(x, params["encoder_ln"]["s"], params["encoder_ln"]["b"], eps)

    heads = cfg["num_attention_heads"]
    rows, frames, width = x.shape
    hd = width // heads
    for p in params["layers"][:output_layer]:
        q, k_, v = (_linear(x, p[f"{n}_w"], p[f"{n}_b"]).reshape(rows, frames, heads, hd).transpose(1, 2)
                    for n in "qkv")
        weights = torch.softmax((q @ k_.transpose(-1, -2)) / hd**0.5, dim=-1)
        ctx = (weights @ v).transpose(1, 2).reshape(rows, frames, width)
        x = _layer_norm(x + _linear(ctx, p["o_w"], p["o_b"]), p["ln1_s"], p["ln1_b"], eps)
        h = _gelu(_linear(x, p["ff_w1"], p["ff_b1"]), gelu)
        x = _layer_norm(x + _linear(h, p["ff_w2"], p["ff_b2"]), p["ln2_s"], p["ln2_b"], eps)
    return x


def f1(clean_h: torch.Tensor, denoised_h: torch.Tensor) -> torch.Tensor:
    """(pairs, frames, hidden) twice -> (pairs,) SpeechBERTScore F1."""
    c = clean_h / torch.linalg.norm(clean_h, dim=2, keepdim=True)
    d = denoised_h / torch.linalg.norm(denoised_h, dim=2, keepdim=True)
    sim = d @ c.transpose(1, 2)
    precision = sim.amax(dim=2).mean(dim=1)
    recall = sim.amax(dim=1).mean(dim=1)
    return 2 * precision * recall / (precision + recall)


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
