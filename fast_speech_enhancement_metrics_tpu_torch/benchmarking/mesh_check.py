"""Data-parallel work-division check on a ``torch.distributed`` mesh.

Counterpart of the JAX package's ``benchmarking/mesh_check.py``. Every rank
calls ``run_mesh_check`` with the same mesh: each metric's batch must split
over the ``data`` axis (each rank holds exactly ``batch / data`` rows), and
the all-gathered scores must match the same metric on the rank's device
without a mesh. Only the (B,) score vectors cross between ranks; the audio
never does. Rank 0 writes ``results/torch/mesh_check.json``.

The JAX package ran N virtual CPU devices in one process; here N gloo
ranks on the CPU give the same check, and NCCL ranks on the cards (one
card per rank: NCCL refuses two ranks on one card). Run it with
``FSEM_BENCH_MESH=N python -m
fast_speech_enhancement_metrics_tpu_torch.benchmarking.bench``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: a small encoder of mHuBERT-147's structure: the sharding and work
#: division are those of the full model, the CPU time is tractable
TINY_HUBERT = dict(
    hidden_size=64,
    num_hidden_layers=3,
    num_attention_heads=4,
    intermediate_size=96,
    conv_dim=(32, 32, 32),
    conv_kernel=(10, 3, 3),
    conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)


def run_mesh_check(mesh, batch: int = 16, duration_s: int = 4, results_dir: str = "results/torch") -> dict:
    """All six metrics on ``mesh`` against the rank's device alone; the
    report (the same on every rank)."""
    from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, PESQ, SDR, STOI, SpeechBERTScore
    from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig, init_params
    from fast_speech_enhancement_metrics_tpu_torch.parallel.mesh import axis_size, mesh_device
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    n_data = axis_size(mesh, "data")
    device = mesh_device(mesh)
    clean, noisy, _ = load_audio_data(duration_s, batch, 16000)

    tiny = HubertConfig(**TINY_HUBERT)
    sbs_kw = dict(params=init_params(torch.Generator().manual_seed(0), tiny), config=tiny, output_layer=3)
    cases = {
        "LSD": (LSD, {}),
        "SDR": (SDR, {}),
        "STOI": (STOI, {}),
        "PESQ": (PESQ, {}),
        "DNSMOS": (DNSMOS, {}),
        "SpeechBERTScore": (SpeechBERTScore, sbs_kw),
    }

    report = {"n_devices": dist.get_world_size(), "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
              "device_type": mesh.device_type, "batch": batch, "duration_s": duration_s}
    checks = []
    for name, (cls, kw) in cases.items():
        single = cls(device=device, **kw)
        sharded = cls(mesh=mesh, **kw)

        args = (None if cls.NON_INTRUSIVE else clean, noisy)
        ref = single(*args)
        dist.barrier()
        t0 = time.perf_counter()
        got = sharded(*args)
        wall_s = time.perf_counter() - t0

        # physical work division: each data rank owns exactly batch / N utterances
        rows = [None] * n_data
        dist.all_gather_object(rows, sharded.prepare_audio(noisy).shape[0], group=mesh.get_group("data"))
        shard_rows = sorted(rows)
        divided = shard_rows == [batch // n_data] * n_data

        max_dev = max(abs(a[k] - b[k]) for a, b in zip(ref, got) for k in a)
        checks.append({
            "metric": name,
            "work_divided": bool(divided),
            "shard_rows": shard_rows,
            "max_dev_vs_single_device": float(max_dev),
            "wall_s": round(wall_s, 2),
        })
        if dist.get_rank() == 0:
            print(f"# mesh {name}: divided={divided} max_dev={max_dev:.2e}", flush=True)

    report["checks"] = checks
    report["ok"] = all(c["work_divided"] and c["max_dev_vs_single_device"] < 5e-3 for c in checks)
    if dist.get_rank() == 0:
        Path(results_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(results_dir) / "mesh_check.json", "w") as f:
            json.dump(report, f, indent=2)
    return report
