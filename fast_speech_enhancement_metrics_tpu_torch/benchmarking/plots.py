"""Plots from the port's sweep results (reference: benchmarking/plotting/*).

Counterpart of the JAX package's ``benchmarking/plots.py``, written under
``plots/torch/``:

* ``samples_per_second.png`` — per-metric throughput bars on the card
  beside the upstream reference's published GPU numbers, with the speedup,
* ``samples_per_second_scaling.png`` — throughput against batch size,
* ``deviations.png`` — per-utterance scores of the port against float64
  oracle scores of ``port_scores``' synthetic set (``plot_deviations``; the
  oracles live in the tests, which import the JAX package, so the caller
  computes and passes them).

matplotlib is imported only when a plot is drawn. Usage::

    python -m fast_speech_enhancement_metrics_tpu_torch.benchmarking.plots
"""

from __future__ import annotations

import json
from pathlib import Path

from fast_speech_enhancement_metrics_tpu_torch.benchmarking.runner import REFERENCE_GPU_AUDIO_S

METRIC_ORDER = ["PESQ", "STOI", "SDR", "LSD", "DNSMOS", "SpeechBERTScore"]
#: the deviation panels: title -> (metric, score key)
DEVIATION_CASES = {
    "PESQ": ("PESQ", "PESQ"),
    "STOI": ("STOI", "STOI"),
    "ESTOI": ("STOI", "ESTOI"),
    "SDR": ("SDR", "SDR"),
    "LSD": ("LSD", "LSD"),
    "DNSMOS": ("DNSMOS", "OVRL"),
}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_results(results_dir: str = "results/torch") -> dict:
    """{metric: {batch: record}} from the sweep output tree."""
    out: dict = {}
    for batch_dir in sorted(Path(results_dir).glob("batch_size_*")):
        batch = int(batch_dir.name.rsplit("_", 1)[1])
        for path in batch_dir.glob("*_results.json"):
            with open(path) as f:
                record = json.load(f)
            out.setdefault(record["metric"], {})[batch] = record
    return out


def plot_samples_per_second(results, out="plots/torch/samples_per_second.png", batch=64):
    plt = _pyplot()
    names = [m for m in METRIC_ORDER if m in results and batch in results[m]]
    ours = [results[m][batch]["samples_per_s"] for m in names]
    ref = [REFERENCE_GPU_AUDIO_S[m] / 16.0 for m in names]
    cards = sorted({results[m][batch].get("device", "unknown device") for m in names})

    fig, ax = plt.subplots(figsize=(9, 4.5))
    x = range(len(names))
    ax.bar([i - 0.2 for i in x], ref, width=0.4, label="reference GPU (published)", color="#999")
    ax.bar([i + 0.2 for i in x], ours, width=0.4, label=f"ours, {', '.join(cards)}", color="#76b900")
    for i, (o, r) in enumerate(zip(ours, ref)):
        speedup = o / r
        label = f"{speedup:.0f}×" if speedup >= 10 else f"{speedup:.2f}×"
        ax.text(i + 0.2, o, label, ha="center", va="bottom", fontsize=9)
    ax.set_yscale("log")
    ax.set_xticks(list(x), names, rotation=15)
    ax.set_ylabel(f"samples/s (16 s clips, batch {batch})")
    ax.legend()
    fig.tight_layout()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)


def plot_scaling(results, out="plots/torch/samples_per_second_scaling.png"):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name in METRIC_ORDER:
        if name not in results:
            continue
        batches = sorted(results[name])
        ax.plot(batches, [results[name][b]["samples_per_s"] for b in batches], marker="o", label=name)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("batch size")
    ax.set_ylabel("samples/s")
    ax.legend(fontsize=8)
    fig.tight_layout()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)


def port_scores(num_samples: int = 8, duration_s: int = 4, device=None) -> dict:
    """The port's scores of ``DEVIATION_CASES`` on the synthetic set that
    ``plot_deviations`` compares: {title: (num_samples,) array}."""
    import numpy as np

    from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, PESQ, SDR, STOI
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    clean, noisy, _ = load_audio_data(duration_s, num_samples, 16000)
    metrics = {"PESQ": PESQ(device=device), "STOI": STOI(sample_rate=16000, device=device),
               "SDR": SDR(device=device), "LSD": LSD(device=device), "DNSMOS": DNSMOS(device=device)}
    rows = {name: m(None if m.NON_INTRUSIVE else clean, noisy) for name, m in metrics.items()}
    return {title: np.array([r[key] for r in rows[name]]) for title, (name, key) in DEVIATION_CASES.items()}


def plot_deviations(oracle: dict, ours: dict | None = None, out="plots/torch/deviations.png"):
    """Scatter the port's scores (``ours``; by default ``port_scores()`` on
    the card) against float64 oracle scores of the same utterances
    (``oracle``, {title: array}), one panel per key of ``DEVIATION_CASES``."""
    import numpy as np

    if ours is None:
        ours = port_scores()
    plt = _pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(12, 7))
    for ax, title in zip(axes.flat, DEVIATION_CASES):
        expected, got = np.asarray(oracle[title]), np.asarray(ours[title])
        dev = float(np.abs(got - expected).max())
        ax.scatter(expected, got, s=18)
        lo, hi = min(expected.min(), got.min()), max(expected.max(), got.max())
        ax.plot([lo, hi], [lo, hi], "k--", lw=0.7)
        ax.set_title(f"{title}  (max dev {dev:.1e})", fontsize=10)
        ax.set_xlabel("float64 oracle")
        ax.set_ylabel("ours")
    fig.tight_layout()
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)


def main() -> None:
    results = load_results()
    if not results:
        raise SystemExit("no results under results/torch/: run benchmarking.sweep first")
    batches = {b for r in results.values() for b in r}
    plot_samples_per_second(results, batch=64 if 64 in batches else max(batches))
    plot_scaling(results)
    print("plots written to plots/torch/ (deviations.png needs oracle scores: plot_deviations)")


if __name__ == "__main__":
    main()
