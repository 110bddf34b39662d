"""DNSMOS P.835: weights, the metric under test, its FLOPs, its reference.

The weights are the committed ``sig_bak_ovr`` checkpoint that the
configuration file names; the program and the reference each read that raw
file themselves.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.reference import dnsmos as reference_dnsmos
from portbench.systems import allow_tf32

ROOT = Path(__file__).resolve().parents[2]
SCORE_KEYS = ("SIG", "BAK", "OVRL")


def make_weights(config: dict, seed: int, device: torch.device) -> str:
    del seed, device  # real weights: the same for every seed
    return str(ROOT / config["weights"])


def build_metric(config: dict, weights: str, device: torch.device, variant: str | None):
    """The program's ``DNSMOS`` at the configuration's keywords;
    ``variant``, the name of one of its ``controls``, adds that control's
    lower-precision ones."""
    from fast_speech_enhancement_metrics_tpu_torch import DNSMOS

    kwargs = dict(config["metric_kwargs"])
    if variant is not None:
        kwargs.update(config["controls"][variant])
    if kwargs.pop("tf32", False):
        allow_tf32()
    if "conv_dtype" in kwargs:
        kwargs["conv_dtype"] = getattr(torch, kwargs["conv_dtype"])
    return DNSMOS(checkpoint=weights, device=device, **kwargs)


def clip_flops(config: dict, samples: int) -> float:
    """Least FLOPs of one clip: the learned STFT and the conv trunk once over
    the clip as tiled to a window (the windows overlap by 8 of 9.01 s and
    share them), and the MLP per window. The per-window edge strips and the
    second pool-3 phase of conv 6 are left out, so this counts low."""
    m = config["model"]
    window, hop = m["window_samples"], m["hop_samples"]
    tiled = samples
    while tiled < window:
        tiled *= 2
    frames = tiled // m["stft_hop"] - 1
    bins = m["stft_bins"]
    flops = 2.0 * frames * m["stft_taps"] * 2 * bins
    rows, cols, c_in = frames, bins, 1
    for n, c_out in enumerate(m["conv_channels"]):
        flops += 2.0 * rows * cols * c_in * c_out * 9
        c_in = c_out
        if n in m["pool_after"]:
            rows, cols = rows // 2, cols // 2
    windows = (tiled - window) // hop + 1
    widths = [c_in, *m["mlp_widths"]]
    flops += windows * sum(2.0 * a * b for a, b in zip(widths, widths[1:]))
    return flops


def call_flops(config: dict, lengths) -> float:
    return sum(clip_flops(config, n) for n in lengths)


class Reference:
    keys = SCORE_KEYS

    def __init__(self, config: dict, weights: str, device: torch.device):
        self.w = reference_dnsmos.load(weights, device)
        self.device = device

    def scores(self, clean, denoised) -> list[dict[str, float]]:
        del clean  # non-intrusive
        return [reference_dnsmos.clip_scores(self.w, torch.from_numpy(d).to(self.device)) for d in denoised]
