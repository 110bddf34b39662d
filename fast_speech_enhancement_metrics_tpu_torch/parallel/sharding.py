"""Sharding rules: batch data parallelism and HuBERT tensor parallelism.

Counterpart of the JAX package's ``parallel/sharding.py``, its
``PartitionSpec``s written as ``torch.distributed.tensor`` placements, one
per mesh axis ``("data", "model")``. The HuBERT layout is the Megatron
split:

* q/k/v projections: output (head) columns over ``model`` (``Shard(1)``),
  their biases too (``Shard(0)``): attention runs on local heads only,
* attention output projection: input rows over ``model`` (``Shard(0)``),
  all-reduced after, its bias replicated and added once,
* FFN: the first product's columns and bias, the second's rows,
* everything small (LayerNorms, the reduced products' biases, the conv
  feature encoder, DNSMOS) replicated.

Every rank holds the full parameters (the same seed or checkpoint), so
``shard_params`` slices them locally; no collective moves weights.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig
from fast_speech_enhancement_metrics_tpu_torch.parallel.mesh import axis_size


def batch_sharding(mesh) -> tuple:
    """Utterance batches shard over the ``data`` axis."""
    del mesh
    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    del mesh
    return (Replicate(), Replicate())


def _layer_specs() -> dict:
    """The ``model``-axis placement of each parameter of one transformer layer."""
    col = Shard(1)  # output dim sharded
    row = Shard(0)  # input dim sharded
    rep = Replicate()
    return {
        "q_w": col, "q_b": Shard(0),
        "k_w": col, "k_b": Shard(0),
        "v_w": col, "v_b": Shard(0),
        "o_w": row, "o_b": rep,
        "ln1_s": rep, "ln1_b": rep,
        "ff_w1": col, "ff_b1": Shard(0),
        "ff_w2": row, "ff_b2": rep,
        "ln2_s": rep, "ln2_b": rep,
    }


def hubert_param_sharding(mesh, config: HubertConfig, params) -> dict:
    """Pytree of placements ``(data, model)`` matching a HuBERT parameter
    pytree: replicated over ``data``, the layers' products split over
    ``model``, which must divide the head count and the FFN width (1 =
    fully replicated)."""
    tp = axis_size(mesh, "model")
    if config.num_attention_heads % tp or config.intermediate_size % tp:
        raise ValueError(
            f"model axis {tp} must divide heads {config.num_attention_heads} "
            f"and FFN width {config.intermediate_size}"
        )

    def rep(tree):
        if isinstance(tree, dict):
            return {k: rep(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rep(v) for v in tree]
        return replicated(mesh)

    out = rep({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = [{k: (Replicate(), p) for k, p in _layer_specs().items()} for _ in params["layers"]]
    return out


def shard_params(params, mesh, config: HubertConfig) -> dict:
    """This rank's part of a HuBERT parameter pytree (the JAX package's
    layout, numpy or tensor leaves): each layer leaf cut to the local shard
    of its ``model`` placement, as a plain float32 tensor; the rest as
    given."""
    placements = hubert_param_sharding(mesh, config, params)
    tp = axis_size(mesh, "model")
    rank = mesh.get_local_rank("model")
    layers = []
    for layer, specs in zip(params["layers"], placements["layers"]):
        local = {}
        for k, v in layer.items():
            t = torch.as_tensor(v, dtype=torch.float32)
            p = specs[k][1]
            local[k] = torch.chunk(t, tp, dim=p.dim)[rank].contiguous() if isinstance(p, Shard) else t
        layers.append(local)
    return {**params, "layers": layers}
