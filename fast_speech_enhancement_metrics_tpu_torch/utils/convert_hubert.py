"""HuBERT weights: the npz format, the fold of a Hugging Face state dict, and the converter CLI.

The port's own copy of the JAX package's ``utils/convert_hubert.py``
(``save_params`` / ``load_params``, ``convert_pretrained``, ``main``) and of
``models/hubert.py``'s ``convert_hf_hubert``: the same flat ``a.b.0.c``-keyed
float32 ``.npz`` and the same parameter pytree (JAX layout, numpy leaves),
so one converted file serves both packages. ``from_jax_params``
(``models/hubert.py``) carries a loaded pytree into the port's
``HubertEncoder``.

``python -m fast_speech_enhancement_metrics_tpu_torch.utils.convert_hubert
[model_name_or_path] [output.npz]`` loads an HF ``HubertModel`` (default
``utter-project/mHuBERT-147``, from a local directory or the hub cache; a
hub name not yet cached needs the network), folds it and writes the npz
that ``SpeechBERTScore`` loads offline (``checkpoints/mhubert147.npz``).
An HF ``WavLMModel`` (``model_type`` "wavlm", e.g. ``microsoft/wavlm-large``)
converts the same way, with its gate leaves and layer 0's bucket table;
score it with ``SpeechBERTScore(checkpoint=..., config=WAVLM_LARGE_CONFIG,
output_layer=14)``.
"""

from __future__ import annotations

import sys

import numpy as np

from fast_speech_enhancement_metrics_tpu_torch.models.hubert import MHUBERT_147_CONFIG, HubertConfig

MHUBERT_147 = "utter-project/mHuBERT-147"
WAVLM_LARGE = "microsoft/wavlm-large"


def save_params(params, path: str) -> None:
    """Flatten the nested pytree to a ``a.b.0.c``-keyed float32 npz."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            flat[prefix] = np.asarray(node, dtype=np.float32)

    walk(params, "")
    np.savez(path, **flat)


def load_params(path: str) -> dict:
    """Rebuild the nested pytree (float32 numpy leaves) from a flat npz."""
    with np.load(path) as data:
        flat = dict(data)
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value, dtype=np.float32)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def config_from_hf(hf_config) -> HubertConfig:
    """HF ``HubertConfig`` or ``WavLMConfig`` (any object with its
    attributes; ``model_type`` "wavlm" for WavLM) -> ``HubertConfig``."""
    wavlm = getattr(hf_config, "model_type", "hubert") == "wavlm"
    extra = dict(relative_position_bias=True, num_buckets=hf_config.num_buckets,
                 max_bucket_distance=hf_config.max_bucket_distance) if wavlm else {}
    return HubertConfig(
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        conv_dim=tuple(hf_config.conv_dim),
        conv_kernel=tuple(hf_config.conv_kernel),
        conv_stride=tuple(hf_config.conv_stride),
        conv_bias=hf_config.conv_bias,
        feat_extract_norm=hf_config.feat_extract_norm,
        feat_proj_layer_norm=getattr(hf_config, "feat_proj_layer_norm", True),  # WavLM's always has one
        num_conv_pos_embeddings=hf_config.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=hf_config.num_conv_pos_embedding_groups,
        do_stable_layer_norm=hf_config.do_stable_layer_norm,
        layer_norm_eps=hf_config.layer_norm_eps,
        **extra,
    )


def convert_hf_hubert(state_dict, config: HubertConfig = MHUBERT_147_CONFIG) -> dict:
    """Map an HF ``HubertModel`` (or, with ``config.relative_position_bias``,
    ``WavLMModel``) state dict to the parameter pytree.

    Folds the positional conv's parametrizations (plain, weight-norm in old
    or new naming, batch-norm) in float64 on the host; the leaves come out
    float32. WavLM's layers also carry ``gate_w`` (hd, 8) (in, out),
    ``gate_b`` (8,) and ``gate_const`` (heads,), and the tree layer 0's
    ``rel_embed`` (num_buckets, heads).
    """

    def g(key):
        v = state_dict[key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float64)

    params: dict = {"feature_encoder": []}
    for i in range(len(config.conv_dim)):
        prefix = f"feature_extractor.conv_layers.{i}"
        layer = {"w": g(f"{prefix}.conv.weight").transpose(2, 1, 0)}  # OIK -> KIO
        if config.conv_bias:
            layer["b"] = g(f"{prefix}.conv.bias")
        if f"{prefix}.layer_norm.weight" in state_dict:
            layer["norm_scale"] = g(f"{prefix}.layer_norm.weight")
            layer["norm_bias"] = g(f"{prefix}.layer_norm.bias")
        params["feature_encoder"].append(layer)

    params["feature_projection"] = {
        "w": g("feature_projection.projection.weight").T,
        "b": g("feature_projection.projection.bias"),
    }
    if config.feat_proj_layer_norm:
        params["feature_projection"]["ln_s"] = g("feature_projection.layer_norm.weight")
        params["feature_projection"]["ln_b"] = g("feature_projection.layer_norm.bias")

    pc = "encoder.pos_conv_embed"
    if f"{pc}.conv.weight_g" in state_dict or f"{pc}.conv.parametrizations.weight.original0" in state_dict:
        if f"{pc}.conv.weight_g" in state_dict:
            g_w, v_w = g(f"{pc}.conv.weight_g"), g(f"{pc}.conv.weight_v")
        else:
            g_w = g(f"{pc}.conv.parametrizations.weight.original0")
            v_w = g(f"{pc}.conv.parametrizations.weight.original1")
        # torch weight_norm dim=2 on (O, I/g, K): per-k norm over (O, I/g)
        weight = g_w * v_w / np.sqrt((v_w**2).sum(axis=(0, 1), keepdims=True))
    else:
        weight = g(f"{pc}.conv.weight")
    params["pos_conv"] = {"w": weight.transpose(2, 1, 0), "b": g(f"{pc}.conv.bias")}
    if f"{pc}.batch_norm.running_mean" in state_dict:
        # eval-mode BN on the conv input is a per-channel affine x*s + t; it
        # stays a pre-transform because the conv zero-pads the BN output
        mean = g(f"{pc}.batch_norm.running_mean")
        var = g(f"{pc}.batch_norm.running_var")
        s = g(f"{pc}.batch_norm.weight") / np.sqrt(var + 1e-5)
        params["pos_conv"]["bn_scale"] = s
        params["pos_conv"]["bn_shift"] = g(f"{pc}.batch_norm.bias") - mean * s

    params["encoder_ln"] = {"s": g("encoder.layer_norm.weight"), "b": g("encoder.layer_norm.bias")}
    names = {
        "q_w": "attention.q_proj.weight", "q_b": "attention.q_proj.bias",
        "k_w": "attention.k_proj.weight", "k_b": "attention.k_proj.bias",
        "v_w": "attention.v_proj.weight", "v_b": "attention.v_proj.bias",
        "o_w": "attention.out_proj.weight", "o_b": "attention.out_proj.bias",
        "ln1_s": "layer_norm.weight", "ln1_b": "layer_norm.bias",
        "ff_w1": "feed_forward.intermediate_dense.weight",
        "ff_b1": "feed_forward.intermediate_dense.bias",
        "ff_w2": "feed_forward.output_dense.weight",
        "ff_b2": "feed_forward.output_dense.bias",
        "ln2_s": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
    }
    params["layers"] = []
    for i in range(config.num_hidden_layers):
        layer = {}
        for ours, theirs in names.items():
            v = g(f"encoder.layers.{i}.{theirs}")
            layer[ours] = v.T if ours.endswith(("_w", "_w1", "_w2")) else v
        if config.relative_position_bias:
            prefix = f"encoder.layers.{i}.attention"
            layer["gate_w"] = g(f"{prefix}.gru_rel_pos_linear.weight").T
            layer["gate_b"] = g(f"{prefix}.gru_rel_pos_linear.bias")
            layer["gate_const"] = g(f"{prefix}.gru_rel_pos_const").reshape(-1)
        params["layers"].append(layer)
    if config.relative_position_bias:
        params["rel_embed"] = g("encoder.layers.0.attention.rel_attn_embed.weight")

    def to_f32(node):
        if isinstance(node, dict):
            return {k: to_f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_f32(v) for v in node]
        return np.ascontiguousarray(node, dtype=np.float32)

    return to_f32(params)


def convert_pretrained(name_or_path: str = MHUBERT_147) -> tuple[dict, HubertConfig]:
    """Load an HF ``HubertModel`` or ``WavLMModel`` (hub cache or local dir;
    the config's ``model_type`` picks the layout) -> (params, config)."""
    from transformers import AutoModel

    model = AutoModel.from_pretrained(name_or_path)
    config = config_from_hf(model.config)
    return convert_hf_hubert(model.state_dict(), config), config


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def main(name: str = MHUBERT_147, out: str = "mhubert147.npz") -> None:
    params, config = convert_pretrained(name)
    save_params(params, out)
    n = sum(int(np.prod(np.shape(x))) for x in _leaves(params))
    print(f"wrote {out}: {n/1e6:.1f} M parameters, config={config}")


if __name__ == "__main__":
    main(*sys.argv[1:])
