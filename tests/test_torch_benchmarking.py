"""The port's bench harness on the CPU, at small sizes, beside the JAX package's.

On a CPU device ``bench_one`` runs the graph protocol's recurrence as an
eager loop (``protocol: "loop"``); the CUDA graph itself runs only on the
card (``chip_smoke.py``'s bench-harness phase).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import LSD, SpeechBERTScore
from fast_speech_enhancement_metrics_tpu_torch.benchmarking import plots
from fast_speech_enhancement_metrics_tpu_torch.benchmarking.runner import (
    REFERENCE_GPU_AUDIO_S,
    SCAN_K_MAX,
    _Scan,
    bench_one,
    make_metrics,
)
from fast_speech_enhancement_metrics_tpu_torch.benchmarking.sweep import run_sweep
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig, init_params
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

JAX_RECORD_KEYS = {"metric", "batch", "audio_seconds_per_s", "samples_per_s", "per_call_ms", "protocol",
                   "batches_timed", "compile_s", "ref_gpu_audio_seconds_per_s", "speedup_vs_ref_gpu"}


def test_bench_one_record(speech_data):
    record = bench_one("LSD", LSD(device="cpu"), speech_data["speech"][:2], speech_data["noisy_speech"][:2],
                       duration_s=4, time_budget_s=0.2)
    assert JAX_RECORD_KEYS <= set(record)
    assert record["metric"] == "LSD" and record["batch"] == 2
    assert record["audio_seconds_per_s"] > 0
    assert record["speedup_vs_ref_gpu"] == record["audio_seconds_per_s"] / 208000.0
    assert record["protocol"] == "loop" and record["device"] == "cpu"
    assert record["batches_timed"] % 32 == 0 and record["graph_launches"] is None


def test_bench_one_host_plan_takes_per_call():
    """A metric with a host-orchestrated plan (``host_chunk``) is timed per
    call, as in the JAX package."""
    config = HubertConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                          conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=4,
                          num_conv_pos_embedding_groups=2)
    metric = SpeechBERTScore(device="cpu", params=init_params(torch.Generator().manual_seed(0), config),
                             config=config, output_layer=1, host_chunk=2)
    clean, noisy, _ = load_audio_data(1, 2, 16000)
    record = bench_one("SpeechBERTScore", metric, clean, noisy, duration_s=1, time_budget_s=0.05)
    assert record["protocol"] == "per_call" and record["batches_timed"] >= 3
    assert record["speedup_vs_ref_gpu"] == record["audio_seconds_per_s"] / 2720.0


def test_sweep_writes_results(tmp_path):
    run_sweep(batch_sizes=[1, 2], duration_s=1, time_budget_s=0.1, metrics=["LSD"], results_dir=str(tmp_path),
              device="cpu")
    for batch in (1, 2):
        path = tmp_path / f"batch_size_{batch}" / "LSD_results.json"
        assert path.exists()
        with open(path) as f:
            record = json.load(f)
        assert record["batch"] == batch and record["device"] == "cpu"


def test_scan_loop_matches_jax_scanned():
    """The port's recurrence (an eager loop on the CPU) and the JAX
    package's ``lax.scan`` on the same 2 x 1 s LSD pair and seed: every row
    within 2e-4, and the offsets each evaluation read the same sequence: the
    first equal, each next the port's recurrence of its own scores bit for
    bit and JAX's of its scores within 2e-4."""
    from fast_speech_enhancement_metrics_tpu import LSD as JaxLSD
    from fast_speech_enhancement_metrics_tpu.benchmarking.runner import _scanned

    clean, noisy, _ = load_audio_data(1, 2, 16000)
    seed, k = 3, 4
    jax_metric = JaxLSD()
    want = np.asarray(_scanned(jax_metric._compute_resampled, True, scan_k=k)(
        *jax_metric.prepare_inputs(clean, noisy), seed)["LSD"])
    metric = LSD(device="cpu")
    scan = _Scan(metric._compute_resampled, True, *metric.prepare_inputs(clean, noisy))
    got = scan(seed, k).numpy()
    assert scan.keys == ["LSD"] and got.shape == (1, k, 2)
    np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-4)

    def recurrence(scores):
        total = np.abs(scores.sum(axis=1, dtype=np.float32))
        nxt = np.mod(total, np.float32(977.0)) * np.float32(1e-12) + np.float32(1e-12)
        return np.concatenate([[np.float32(1e-12 * (seed + 1))], nxt[:-1]]).astype(np.float32)

    eps = scan.eps_history.numpy()
    assert eps[0] == np.float32(1e-12 * (seed + 1))
    np.testing.assert_array_equal(eps, recurrence(got[0]))
    np.testing.assert_allclose(eps, recurrence(want), rtol=2e-4)


def test_scan_offsets_move_every_evaluation():
    """Each evaluation reads an offset set by the last one's scores, and a
    new seed starts a new sequence: no two dispatches are identical."""
    clean, noisy, _ = load_audio_data(1, 2, 16000)
    metric = LSD(device="cpu")
    scan = _Scan(metric._compute_resampled, True, *metric.prepare_inputs(clean, noisy))
    scan(0, 3)
    first = scan.eps_history.clone()
    scan(1, 3)
    assert first[0] != scan.eps_history[0] and first[0] != first[1]


def test_make_metrics_names():
    """The JAX factories' six names, on the device asked for."""
    factories = make_metrics(16000, "cpu")
    assert list(factories) == ["PESQ", "STOI", "SDR", "LSD", "DNSMOS", "SpeechBERTScore"]
    assert set(factories) == set(REFERENCE_GPU_AUDIO_S)
    assert factories["LSD"]().device == torch.device("cpu")
    assert SCAN_K_MAX == 256


def test_make_metrics_default_device_is_the_card(monkeypatch):
    """Without a device the factories build on the card, which raises where
    there is none: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_metrics()["LSD"]()


def _record(name, batch, sps):
    return {"metric": name, "batch": batch, "samples_per_s": sps, "device": "NVIDIA H100 80GB HBM3"}


def test_plots_write_pngs(tmp_path):
    for batch, scale in ((1, 1.0), (64, 30.0)):
        out = tmp_path / "results" / f"batch_size_{batch}"
        out.mkdir(parents=True)
        for name in ("LSD", "SDR"):
            (out / f"{name}_results.json").write_text(json.dumps(_record(name, batch, 1000.0 * scale)))
    results = plots.load_results(str(tmp_path / "results"))
    assert set(results) == {"LSD", "SDR"} and set(results["LSD"]) == {1, 64}
    plots.plot_samples_per_second(results, out=str(tmp_path / "sps.png"))
    plots.plot_scaling(results, out=str(tmp_path / "scaling.png"))
    rs = np.random.RandomState(0)
    oracle = {title: rs.rand(8) for title in plots.DEVIATION_CASES}
    ours = {title: v + 1e-4 * rs.randn(8) for title, v in oracle.items()}
    plots.plot_deviations(oracle, ours, out=str(tmp_path / "dev.png"))
    for png in ("sps.png", "scaling.png", "dev.png"):
        assert (tmp_path / png).stat().st_size > 1000
