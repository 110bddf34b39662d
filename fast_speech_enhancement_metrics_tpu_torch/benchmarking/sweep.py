"""Batch-size throughput sweep (reference: benchmark_metrics.py:111-129).

Counterpart of the JAX package's ``benchmarking/sweep.py``: writes
``results/torch/batch_size_N/<Metric>_results.json`` per batch size, the
layout the plotting consumes, beside (never over) the JAX package's
``results/batch_size_N/``. Each record names the device it was taken on.

Usage::

    python -m fast_speech_enhancement_metrics_tpu_torch.benchmarking.sweep \
        [--batch-sizes 1,2,4,8,16,32,64,128] [--duration 16] [--seconds 5] [--metrics LSD,SDR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from fast_speech_enhancement_metrics_tpu_torch.benchmarking.runner import bench_one, make_metrics

DEFAULT_BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)


def run_sweep(
    batch_sizes=DEFAULT_BATCH_SIZES,
    duration_s: int = 16,
    sample_rate: int = 16000,
    time_budget_s: float = 5.0,
    metrics: list[str] | None = None,
    results_dir: str = "results/torch",
    device=None,
) -> None:
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    clean, noisy, _ = load_audio_data(duration_s, max(batch_sizes), sample_rate)

    factories = make_metrics(sample_rate, device)
    if metrics:
        factories = {k: factories[k] for k in metrics}

    for name, factory in factories.items():
        metric = factory()
        for batch in batch_sizes:
            record = bench_one(name, metric, clean[:batch], noisy[:batch], duration_s, time_budget_s)
            out_dir = Path(results_dir) / f"batch_size_{batch}"
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / f"{name}_results.json", "w") as f:
                json.dump(record, f, indent=2)
            print(json.dumps(record), flush=True)
        del metric


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-sizes", default="1,2,4,8,16,32,64,128")
    parser.add_argument("--duration", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--metrics", default=None)
    args = parser.parse_args()
    run_sweep(
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        duration_s=args.duration,
        time_budget_s=args.seconds,
        metrics=args.metrics.split(",") if args.metrics else None,
    )


if __name__ == "__main__":
    main()
