from fast_speech_enhancement_metrics_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
)
from fast_speech_enhancement_metrics_tpu_torch.parallel.sharding import (
    batch_sharding,
    hubert_param_sharding,
    replicated,
    shard_params,
)

__all__ = [
    "create_mesh",
    "initialize_distributed",
    "batch_sharding",
    "hubert_param_sharding",
    "replicated",
    "shard_params",
]
