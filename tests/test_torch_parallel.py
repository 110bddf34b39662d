"""The port's multi-device layer (``parallel/``) on a 4-rank gloo group.

The counterpart of ``tests/test_parallel.py`` (the JAX package's 8-device
mesh) at its tolerances: one module-scoped launch of 4 CPU ranks on a
(data 2, model 2) ``DeviceMesh``; rank 0 holds each metric on the mesh
against the port's single-device CPU run and writes the scores to an npz,
which the tests read. This file is also the ranks' program::

    python tests/test_torch_parallel.py --rank R --world 4 --port P --out scores.npz

The placements and the size checks are held without a launch.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_speech_enhancement_metrics_tpu_torch.benchmarking.mesh_check import TINY_HUBERT  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig, init_params  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.parallel import create_mesh, hubert_param_sharding  # noqa: E402

WORLD, DATA, MODEL = 4, 2, 2
LAUNCH_TIMEOUT_S = 300
#: the JAX package's TP test config: 3 layers, 4 heads, FFN 96
TINY = HubertConfig(**TINY_HUBERT)


# -- the ranks' program -----------------------------------------------------------


def _rank_main(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, PESQ, SDR, STOI, SpeechBERTScore
    from fast_speech_enhancement_metrics_tpu_torch.benchmarking.mesh_check import run_mesh_check
    from fast_speech_enhancement_metrics_tpu_torch.parallel import initialize_distributed, shard_params
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    initialize_distributed("cpu")
    mesh = create_mesh(data=DATA, model=MODEL, device_type="cpu")
    clean, noisy, _ = load_audio_data(4, 4, 16000)  # the conftest's speech_data
    res: dict = {}

    def both(key, cls, c, d, **kw):
        """The metric on the mesh (every rank) and alone on rank 0."""
        got = cls(mesh=mesh, **kw)(c, d)
        res[f"{key}/mesh"] = np.array([list(r.values()) for r in got])
        if rank == 0:
            res[f"{key}/single"] = np.array([list(r.values()) for r in cls(device="cpu", **kw)(c, d)])

    for cls in (LSD, SDR, PESQ):
        both(cls.__name__, cls, clean, noisy)
    both("STOI", STOI, clean, noisy, sample_rate=16000)
    both("DNSMOS", DNSMOS, None, noisy)
    for batch in (1, 3):
        both(f"LSD_batch{batch}", LSD, clean[:batch], noisy[:batch])
    # lengths: 3 utterances at T - 160, 1 at T -> groups of 3 and 1
    ragged_c = [r[:-160] for r in clean[:3]] + [clean[3]]
    ragged_d = [r[:-160] for r in noisy[:3]] + [noisy[3]]
    both("LSD_ragged", LSD, ragged_c, ragged_d)

    params = init_params(torch.Generator().manual_seed(0), TINY)
    # 2 s of each pair: 1600 frames of the tiny encoder's stride 20 (its
    # einsum attention is most of the ranks' time)
    both("SBS", SpeechBERTScore, clean[:, :32000], noisy[:, :32000], params=params, config=TINY, output_layer=3)
    # the attention-kernel route that TP keeps for long audio (A9, its plain
    # version on the CPU), on 1 s pairs: 800 frames of the tiny encoder's stride 20
    both("SBS_sdpa", SpeechBERTScore, clean[:2, :16000], noisy[:2, :16000], params=params, config=TINY,
         output_layer=3, attention_impl="sdpa")

    # this rank's shards: each sharded leaf is the model-rank's chunk
    local = shard_params(params, mesh, TINY)["layers"][0]
    m = mesh.get_local_rank("model")
    full = params["layers"][0]
    res[f"shards_ok/{rank}"] = np.array([
        local["q_w"].shape == (64, 32) and torch.equal(local["q_w"], torch.from_numpy(full["q_w"][:, 32 * m:32 * m + 32]))
        and local["ff_w2"].shape == (48, 64)
        and torch.equal(local["ff_w2"], torch.from_numpy(full["ff_w2"][48 * m:48 * m + 48]))
        and torch.equal(local["o_b"], torch.from_numpy(full["o_b"]))
    ])
    try:
        SpeechBERTScore(params=params, config=TINY, output_layer=3, mesh=mesh, attention_impl="block_ffn")(
            clean[:2], noisy[:2])
        res["block_route_raises"] = np.array(False)
    except ValueError:
        res["block_route_raises"] = np.array(True)

    report = run_mesh_check(mesh, batch=4, duration_s=1, results_dir=str(Path(out).parent))
    res["mesh_check/shard_rows"] = np.array([c["shard_rows"] for c in report["checks"]])
    res["mesh_check/max_dev"] = np.array([c["max_dev_vs_single_device"] for c in report["checks"]])
    res["mesh_check/ok"] = np.array(report["ok"])

    gathered = [None] * world
    dist.all_gather_object(gathered, {k: v for k, v in res.items() if k.startswith("shards_ok/")})
    if rank == 0:
        for g in gathered:
            res.update(g)
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK rank={rank}", flush=True)


# -- the launch --------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(port: int, out: Path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"  # xdist already runs a worker per core
    procs = [
        subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(WORLD), "--port", str(port),
                          "--out", str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_parallel") / "scores.npz"
    # the free-port probe races (the socket closes before rank 0 binds it):
    # retry once on a fresh port, only when the failure is a bind or connect error
    port_race = re.compile(r"(address already in use|connection refused|failed to connect|bind)", re.IGNORECASE)
    for attempt in range(2):
        procs, outputs = _launch(_free_port(), out)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
        if not any(p.returncode != 0 and port_race.search(o) for p, o in zip(procs, outputs)):
            break
    for rank, (p, stdout) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{stdout[-3000:]}"
        assert f"WORKER_OK rank={rank}" in stdout
    return dict(np.load(out))


def _assert_close(ranks, key, atol):
    mesh, single = ranks[f"{key}/mesh"], ranks[f"{key}/single"]
    assert mesh.shape == single.shape
    np.testing.assert_allclose(mesh, single, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["LSD", "SDR", "PESQ"])
def test_data_parallel_consistency(ranks, name):
    # SDR is in dB (values ~ +-20) after a long float32 Levinson recursion
    _assert_close(ranks, name, 1e-3 if name == "SDR" else 5e-5)


def test_stoi_data_parallel_consistency(ranks):
    _assert_close(ranks, "STOI", 5e-5)


def test_dnsmos_replicated_consistency(ranks):
    _assert_close(ranks, "DNSMOS", 5e-5)


@pytest.mark.parametrize("batch", [1, 3])
def test_data_parallel_indivisible_batch(ranks, batch):
    """Batches that do not divide the data axis are padded with replicas of
    the last row, and ``compute`` drops the pad scores."""
    assert ranks[f"LSD_batch{batch}/mesh"].shape == (batch, 1)
    _assert_close(ranks, f"LSD_batch{batch}", 5e-5)


def test_ragged_batch_on_mesh(ranks):
    """Exact-length groups of 3 and 1 each split over the data axis."""
    assert ranks["LSD_ragged/mesh"].shape == (4, 1)
    _assert_close(ranks, "LSD_ragged", 5e-5)


def test_hubert_tensor_parallel_consistency(ranks):
    """2-way Megatron TP of the encoder (local heads, all-reduced row
    products) gives the single-device F1."""
    _assert_close(ranks, "SBS", 1e-5)


def test_hubert_tensor_parallel_sdpa_route(ranks):
    """The attention-kernel route that TP takes at 1500 frames and more (A9,
    its plain version here) on the local heads gives the single-device F1."""
    _assert_close(ranks, "SBS_sdpa", 1e-5)


def test_tensor_parallel_shards_and_closed_block_routes(ranks):
    """Each rank computes with its model-rank's chunk of each sharded leaf,
    and a block route, which fuses the sharded products, raises."""
    assert all(bool(ranks[f"shards_ok/{r}"]) for r in range(WORLD))
    assert bool(ranks["block_route_raises"])


def test_mesh_check_divides_work(ranks):
    """``run_mesh_check``: each data rank holds 4 / 2 rows of every metric's
    batch, and the mesh scores are within 5e-3 of one device's."""
    assert ranks["mesh_check/shard_rows"].tolist() == [[2, 2]] * 6
    assert float(ranks["mesh_check/max_dev"].max()) < 5e-3
    assert bool(ranks["mesh_check/ok"])


# -- without a launch --------------------------------------------------------------


def test_layer_placements_match_jax_specs():
    """Each layer leaf's model-axis placement is the JAX package's
    PartitionSpec: the axis that names "model" is the one sharded."""
    from torch.distributed.tensor import Replicate, Shard

    from fast_speech_enhancement_metrics_tpu.parallel.sharding import _layer_specs as jax_specs
    from fast_speech_enhancement_metrics_tpu_torch.parallel.sharding import _layer_specs

    ours, theirs = _layer_specs(), jax_specs()
    assert set(ours) == set(theirs)
    for key, spec in theirs.items():
        want = Shard(tuple(spec).index("model")) if "model" in tuple(spec) else Replicate()
        assert ours[key] == want, key


def test_hubert_param_sharding_tree():
    """Placements for every leaf of the pytree: the layers' over (data,
    model), everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh1x2:  # the attributes the sharding reads
        mesh_dim_names, shape = ("data", "model"), (1, 2)

    params = init_params(torch.Generator().manual_seed(0), TINY)
    tree = hubert_param_sharding(Mesh1x2(), TINY, params)
    assert len(tree["layers"]) == TINY.num_hidden_layers
    assert tree["layers"][0]["q_w"] == (Replicate(), Shard(1))
    assert tree["layers"][0]["ff_w2"] == (Replicate(), Shard(0))
    assert tree["pos_conv"]["w"] == (Replicate(), Replicate())
    assert all(p == (Replicate(), Replicate()) for layer in tree["feature_encoder"] for p in layer.values())


@pytest.mark.parametrize("data, model, message", [(-1, 3, "model=3 must divide device count 1"),
                                                  (2, 1, "data\\*model = 2 != device count 1")])
def test_create_mesh_size_errors(monkeypatch, data, model, message):
    """The JAX package's ValueErrors, raised before any process group exists."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=message):
        create_mesh(data=data, model=model, device_type="cpu")


def test_hubert_param_sharding_rejects_indivisible():
    class Mesh1x3:
        mesh_dim_names, shape = ("data", "model"), (1, 3)

    with pytest.raises(ValueError, match="model axis 3 must divide heads 4 and FFN width 96"):
        hubert_param_sharding(Mesh1x3(), TINY, init_params(torch.Generator().manual_seed(0), TINY))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        parser.add_argument(flag, type=int, required=True)
    parser.add_argument("--out", required=True)
    a = parser.parse_args()
    _rank_main(a.rank, a.world, a.port, a.out)
