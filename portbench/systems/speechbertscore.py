"""SpeechBERTScore on HuBERT: weights, the metric under test, its FLOPs, its reference.

The configuration file gives the model's widths under the names of its
published ``config.json``, ``output_layer``, and the metric's keywords.
Weights are made on the device from the seed in a few large calls, in the
layout of a converted checkpoint (matmul weights (in, out), conv weights
(K, in / groups, out), the positional conv's batch norm folded into a
scale and a shift), copied to the host once and handed to both the program
and the reference. Only the ``output_layer`` layers that the metric runs
get weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import hubert as reference_hubert
from portbench.systems import allow_tf32
from portbench.traffic import derived_seed

SCORE_KEYS = ("SpeechBERTScore",)


def _leaves(cfg: dict, layers: int) -> list[tuple[tuple, tuple, str]]:
    """(path in the parameter tree, shape, init) of every parameter."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    out = []
    for i, (c_out, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        c_in = 1 if i == 0 else cfg["conv_dim"][i - 1]
        out.append((("feature_encoder", i, "w"), (k, c_in, c_out), "conv"))
        if cfg["conv_bias"]:
            out.append((("feature_encoder", i, "b"), (c_out,), "bias"))
        if (cfg["feat_extract_norm"] == "group" and i == 0) or cfg["feat_extract_norm"] == "layer":
            out.append((("feature_encoder", i, "norm_scale"), (c_out,), "scale"))
            out.append((("feature_encoder", i, "norm_bias"), (c_out,), "bias"))
    c_last = cfg["conv_dim"][-1]
    out += [(("feature_projection", "w"), (c_last, d), "linear"), (("feature_projection", "b"), (d,), "bias")]
    if cfg["feat_proj_layer_norm"]:
        out += [(("feature_projection", "ln_s"), (c_last,), "scale"), (("feature_projection", "ln_b"), (c_last,), "bias")]
    groups, k = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    out += [(("pos_conv", "w"), (k, d // groups, d), "linear"), (("pos_conv", "b"), (d,), "bias")]
    if cfg["conv_pos_batch_norm"]:
        out += [(("pos_conv", "bn_scale"), (d,), "scale"), (("pos_conv", "bn_shift"), (d,), "bias")]
    out += [(("encoder_ln", "s"), (d,), "scale"), (("encoder_ln", "b"), (d,), "bias")]
    for i in range(layers):
        for n in "qkvo":
            out += [(("layers", i, f"{n}_w"), (d, d), "linear"), (("layers", i, f"{n}_b"), (d,), "bias")]
        out += [(("layers", i, "ff_w1"), (d, ff), "linear"), (("layers", i, "ff_b1"), (ff,), "bias"),
                (("layers", i, "ff_w2"), (ff, d), "linear"), (("layers", i, "ff_b2"), (d,), "bias")]
        for j in (1, 2):
            out += [(("layers", i, f"ln{j}_s"), (d,), "scale"), (("layers", i, f"ln{j}_b"), (d,), "bias")]
    return out


def make_weights(config: dict, seed: int, device: torch.device) -> dict:
    """The parameter tree (numpy float32 leaves) for ``seed``: one normal
    draw on the device for all of it, scaled per leaf (convs He-normal, as
    HF initialises them; matmuls 0.02; norm scales 1 + 0.1 N; biases and
    shifts 0.1 N), one copy to the host."""
    leaves = _leaves(config["model"], config["output_layer"])
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.empty_like(flat)
    shift = torch.zeros_like(flat)
    at = 0
    for (_, shape, init), n in zip(leaves, sizes):
        scale[at:at + n] = math.sqrt(2.0 / (shape[0] * shape[1])) if init == "conv" else {
            "linear": 0.02, "scale": 0.1, "bias": 0.1}[init]
        if init == "scale":
            shift[at:at + n] = 1.0
        at += n
    host = (flat * scale + shift).cpu().numpy()
    tree: dict = {"feature_encoder": [{} for _ in config["model"]["conv_dim"]],
                  "layers": [{} for _ in range(config["output_layer"])]}
    at = 0
    for (path, shape, _), n in zip(leaves, sizes):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(key, str) else node[key]
        node[path[-1]] = host[at:at + n].reshape(shape)
        at += n
    return tree


def build_metric(config: dict, weights: dict, device: torch.device, variant: str | None):
    """The program's ``SpeechBERTScore`` at the configuration's keywords;
    ``variant``, the name of one of its ``controls``, adds that control's
    lower-precision ones."""
    from fast_speech_enhancement_metrics_tpu_torch import SpeechBERTScore
    from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig

    fields = {f.name for f in dataclasses.fields(HubertConfig)}
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items() if k in fields}
    kwargs = dict(config["metric_kwargs"])
    if variant is not None:
        kwargs.update(config["controls"][variant])
    if kwargs.pop("tf32", False):
        allow_tf32()
    if "act_dtype" in kwargs:
        kwargs["act_dtype"] = getattr(torch, kwargs["act_dtype"])
    return SpeechBERTScore(params=weights, config=HubertConfig(**model), output_layer=config["output_layer"],
                           device=device, **kwargs)


def _conv_out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def row_flops(cfg: dict, output_layer: int, samples: int) -> tuple[float, int]:
    """(least FLOPs of one row's hidden state, its frames): the conv
    encoder, the feature projection, the positional conv, and per layer
    the QKV, attention (4 T^2 d), output and FFN products."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    n, c_in, flops = samples, 1, 0.0
    for c_out, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        n = _conv_out(n, k, s)
        flops += 2.0 * n * c_out * c_in * k
        c_in = c_out
    t = n
    flops += 2.0 * t * c_in * d
    flops += 2.0 * t * d * (d // cfg["num_conv_pos_embedding_groups"]) * cfg["num_conv_pos_embeddings"]
    flops += output_layer * (2.0 * t * d * 3 * d + 4.0 * t * t * d + 2.0 * t * d * d + 4.0 * t * d * ff)
    return flops, t


def call_flops(config: dict, lengths) -> float:
    """Least FLOPs of one call: both rows of every pair, and F1's
    similarity product (2 T^2 d a pair)."""
    total = 0.0
    for samples in lengths:
        flops, t = row_flops(config["model"], config["output_layer"], samples)
        total += 2 * flops + 2.0 * t * t * config["model"]["hidden_size"]
    return total


class Reference:
    """The plain reference on the benchmark's weights, laid out on the
    device once."""

    keys = SCORE_KEYS

    def __init__(self, config: dict, weights: dict, device: torch.device):
        self.config = config
        self.params = reference_hubert.on_device(weights, device)
        self.device = device
        self.gelu = config.get("gelu", "erf")

    def captured(self, audio: torch.Tensor) -> torch.Tensor:
        """The conv feature encoder's output for one row of audio on the
        device: (frames, channels)."""
        with reference_hubert.float32_exact(), torch.inference_mode():
            return reference_hubert.features(self.params, self.config["model"], audio.float()[None], self.gelu)[0]

    def scores(self, clean, denoised) -> list[dict[str, float]]:
        """Per-pair scores of one call's arguments (arrays or lists)."""
        cfg, layer = self.config["model"], self.config["output_layer"]
        if isinstance(denoised, list):
            out = []
            for c, d in zip(clean, denoised):
                pair = [torch.from_numpy(a)[None].to(self.device) for a in (c, d)]
                out += reference_hubert.scores(self.params, cfg, *pair, layer, gelu=self.gelu)
            return out
        c, d = (torch.from_numpy(a).to(self.device) for a in (clean, denoised))
        return reference_hubert.scores(self.params, cfg, c, d, layer, gelu=self.gelu)
