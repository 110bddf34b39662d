"""Published peaks of the cards the benchmark knows, by ``torch.cuda.get_device_name()``.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: bf16 tensor cores 989 TFLOP/s, HBM3 3.35 TB/s. A card
the table does not name gets no share of a peak: its readers report
nothing.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str | None) -> dict | None:
    return PEAKS.get(device_name or "")


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time bf16 work can take: the larger of its operations over
    the peak rate and its bytes over the peak bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"])
