"""SpeechBERTScore on WavLM: weights, the metric under test, its FLOPs, its reference.

The configuration file gives the model's widths under the names of its
published ``config.json`` (``microsoft/wavlm-large``), ``output_layer``, and
the metric's keywords. Weights are made on the device from the seed in one
draw, in the layout of a converted checkpoint (``utils/convert_hubert.py``:
matmul weights (in, out), conv weights (K, in / groups, out), the
positional conv's weight norm folded), copied to the host once and handed
to both the program and the reference. Only the ``output_layer`` layers
that the metric runs get weights. Besides the HuBERT leaves of
``systems/speechbertscore.py`` (a LayerNorm after every conv, the feature
projection's LayerNorm, no batch norm), each layer has WavLM's gate
(``gate_w`` (hd, 8), ``gate_b``, ``gate_const`` a head) and the tree layer
0's bucket table ``rel_embed`` (num_buckets, heads).

The check's intermediate (``capture``) is the hidden state after the
``output_layer`` layers, a row of ``hubert_hidden_state``'s output against
the reference's: it holds the conv encoder, the positional conv and the
layers at once, where F1 alone moves too little.

Controls: ``act_bf16`` (the activation stream in bf16), ``residual_bf16``
(planted: only the layers' residual stream kept in bf16 between layers, the
program's route otherwise as it is) and ``no_relpos`` (planted: the
position bias dropped, the table zeroed in the program's copy of the
weights).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import wavlm as reference_wavlm
from portbench.systems import speechbertscore as sbs
from portbench.traffic import derived_seed

SCORE_KEYS = sbs.SCORE_KEYS
#: the scale of each kind of leaf: matmuls 0.02, norm scales 1 + 0.1 N, biases
#: 0.1 N, the bucket table N(0, 1) (``nn.Embedding``'s), the gate's weight
#: N(0, 1 / hd), so that its sigmoids span much of their range
SCALES = {"linear": 0.02, "scale": 0.1, "bias": 0.1, "embed": 1.0}


def _leaves(cfg: dict, layers: int) -> list[tuple[tuple, tuple, str]]:
    """(path in the parameter tree, shape, init) of every parameter."""
    heads = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    out = sbs._leaves({**cfg, "feat_proj_layer_norm": True, "conv_pos_batch_norm": False}, layers)
    for i in range(layers):
        out += [(("layers", i, "gate_w"), (hd, 8), "gate"), (("layers", i, "gate_b"), (8,), "bias"),
                (("layers", i, "gate_const"), (heads,), "scale")]
    return out + [(("rel_embed",), (cfg["num_buckets"], heads), "embed")]


def _program_config_class():
    """The program's ``HubertConfig``; a program without the relative-position
    bias cannot run WavLM, and raises here, before any work."""
    from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig

    if "relative_position_bias" not in {f.name for f in dataclasses.fields(HubertConfig)}:
        raise RuntimeError("this program's HubertConfig has no relative_position_bias: it cannot run WavLM")
    return HubertConfig


def make_weights(config: dict, seed: int, device: torch.device) -> dict:
    """The parameter tree (numpy float32 leaves) for ``seed``: one normal
    draw on the device for all of it, scaled per leaf (convs He-normal, as
    HF initialises them; ``SCALES`` for the rest), one copy to the host."""
    _program_config_class()
    leaves = _leaves(config["model"], config["output_layer"])
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.empty_like(flat)
    shift = torch.zeros_like(flat)
    at = 0
    for (_, shape, init), n in zip(leaves, sizes):
        if init == "conv":
            scale[at:at + n] = math.sqrt(2.0 / (shape[0] * shape[1]))
        elif init == "gate":
            scale[at:at + n] = shape[0] ** -0.5
        else:
            scale[at:at + n] = SCALES[init]
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
    """The program's ``SpeechBERTScore`` at the configuration's keywords, on a
    relative-bias ``HubertConfig`` of the file's widths; ``variant``, the
    name of one of its ``controls``, adds that control's keywords."""
    from fast_speech_enhancement_metrics_tpu_torch import SpeechBERTScore

    config_class = _program_config_class()
    fields = {f.name for f in dataclasses.fields(config_class)}
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items() if k in fields}
    kwargs = dict(config["metric_kwargs"])
    if variant is not None:
        kwargs.update(config["controls"][variant])
    if kwargs.pop("no_relpos", False):
        weights = {**weights, "rel_embed": weights["rel_embed"] * 0.0}
    residual_bf16 = kwargs.pop("residual_bf16", False)
    if "act_dtype" in kwargs:
        kwargs["act_dtype"] = getattr(torch, kwargs["act_dtype"])
    cfg = config_class(**model, feat_proj_layer_norm=True, relative_position_bias=True)
    metric = SpeechBERTScore(params=weights, config=cfg, output_layer=config["output_layer"], device=device, **kwargs)
    if residual_bf16:
        metric.__class__ = _residual_bf16(type(metric))
    return metric


def _residual_bf16(base: type) -> type:
    """``base`` whose encoder keeps the residual stream in bf16 between the
    pre-LN layers of the kernel route: each layer's input and output rounded
    to bf16, everything else as the program runs it (the planted control
    ``residual_bf16``)."""
    from fast_speech_enhancement_metrics_tpu_torch.ops import relpos_attention

    class ResidualBf16(base):
        def _encode(self, audio, impl):
            layer = relpos_attention.prenorm_layer

            def rounded(x, *args, **kwargs):
                return layer(x.to(torch.bfloat16).float(), *args, **kwargs).to(torch.bfloat16).float()

            relpos_attention.prenorm_layer = rounded
            try:
                return base._encode(self, audio, impl)
            finally:
                relpos_attention.prenorm_layer = layer

    return ResidualBf16


def row_flops(cfg: dict, output_layer: int, samples: int) -> tuple[float, int]:
    """(least FLOPs of one row's hidden state, its frames): HuBERT's
    (``systems/speechbertscore.py``) and per layer the gate's product, two
    logits a head from its hd inputs (2 T d 2). The bias's one
    multiply-add a logit is not a product and is not counted."""
    flops, t = sbs.row_flops(cfg, output_layer, samples)
    return flops + output_layer * 4.0 * t * cfg["hidden_size"], t


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
        self.params = reference_wavlm.on_device(weights, device)
        self.device = device
        self.gelu = config.get("gelu", "erf")

    def captured(self, audio: torch.Tensor) -> torch.Tensor:
        """The hidden state after ``output_layer`` layers for one row of audio
        on the device: (frames, hidden)."""
        with reference_wavlm.float32_exact(), torch.inference_mode():
            return reference_wavlm.hidden_state(self.params, self.config["model"], audio.float()[None],
                                                self.config["output_layer"], self.gelu)[0]

    def scores(self, clean, denoised) -> list[dict[str, float]]:
        """Per-pair scores of one call's arguments (arrays or lists)."""
        cfg, layer = self.config["model"], self.config["output_layer"]
        if isinstance(denoised, list):
            out = []
            for c, d in zip(clean, denoised):
                pair = [torch.from_numpy(a)[None].to(self.device) for a in (c, d)]
                out += reference_wavlm.scores(self.params, cfg, *pair, layer, gelu=self.gelu)
            return out
        c, d = (torch.from_numpy(a).to(self.device) for a in (clean, denoised))
        return reference_wavlm.scores(self.params, cfg, c, d, layer, gelu=self.gelu)
