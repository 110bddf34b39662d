"""Process group and device mesh on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. One process (rank)
drives one device; a 2-D ``("data", "model")`` ``DeviceMesh`` over the
ranks splits utterance batches over ``data`` (each rank scores its own
rows as a one-device call, the scores all-gathered) and SpeechBERTScore's
encoder over ``model`` (Megatron tensor parallelism, all-reduces after the
row-sharded products). Launch one process per device with ``torchrun
--nproc-per-node N``; each calls ``initialize_distributed()`` and
``create_mesh(...)``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(device_type: str = "cuda") -> None:
    """Join the process group that the launcher's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``, as ``torchrun`` sets them): NCCL on ``"cuda"``, with
    this process's device set to ``cuda:LOCAL_RANK``, gloo on ``"cpu"``.

    A no-op when a group exists already or ``WORLD_SIZE`` is unset (a
    single process); any other failure raises."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed('cuda'): CUDA is not available; pass 'cpu' for gloo")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        # the rank's card named, so NCCL need not guess it from the global rank
        dist.init_process_group("nccl", device_id=device)
    elif device_type == "cpu":
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def create_mesh(data: int = -1, model: int = 1, device_type: str = "cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` over all ranks.

    ``data=-1`` takes all ranks left once ``model`` is fixed. The model
    axis lies over adjacent ranks (rank = d * model + m), so a tensor
    parallel group is the ranks of one host first. The sizes are checked
    before the process group is touched."""
    n = _world_size()
    if model < 1 or n % model != 0:
        raise ValueError(f"model={model} must divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != device count {n}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
