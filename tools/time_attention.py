"""Time the long-audio attention kernels A9 and A15 of one checkout on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_attention.py [--package-root DIR] [--label NAME]

Imports ``fast_speech_enhancement_metrics_tpu_torch`` from DIR (default:
this checkout) and builds its kernels there, so that two checkouts (for
instance a parent commit unpacked into a directory that git ignores, and
this one) can be timed in turns on one card in one call: parent, change,
change, parent. Prints the card's name and power limit, then one JSON line
per case: the median time of one launch (CUDA events around each of 10
launches after 3 warm-ups; 3 after 1 for A15), with the shape, the softmax
mode and the least time the bf16 tensor cores need for 4 T^2 D operations
per (row, head) at 989 TFLOP/s. ``chip_smoke.py`` times the library
yardstick beside the kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BF16_TC_FLOPS = 989e12  # H100 SXM, dense, at the full 700 W limit
#: (kernel id, softmax mode, batch, heads, frames, head width): SpeechBERTScore's
#: 16 x 60 s path (A9, its three modes), heads of 80 (HuBERT-xlarge) and one
#: 820 s pair (A15)
CASES = (
    ("A9", "exp2", 16, 12, 2999, 64),
    ("A9", "exp2_bf16", 16, 12, 2999, 64),
    ("A9", "exact", 16, 12, 2999, 64),
    ("A9", "exp2", 4, 16, 1499, 80),
    ("A15", "online", 2, 12, 40999, 64),
)


def cuda_ms(fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA card")
    sys.path.insert(0, str(args.package_root.resolve()))
    from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, sdpa_pallas

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kid, mode, b, h, t, d in CASES:
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).mul_(1.2).to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        if kid == "A15":
            kernel = lambda: sdpa_pallas.flash_sdpa(q, k, v, scale)  # noqa: E731
        else:
            kernel = lambda: sdpa_pallas.sdpa(q, k, v, scale, softmax=mode)  # noqa: E731
        warmup, reps = (1, 3) if kid == "A15" else (3, 10)
        row = {"label": args.label, "id": kid, "softmax": mode, "shape": [b, h, t, d],
               "ms": cuda_ms(kernel, warmup, reps),
               "bound_ms": 4 * b * h * t * t * d / PEAK_BF16_TC_FLOPS * 1e3}
        print(json.dumps(row), flush=True)
        del q, k, v


if __name__ == "__main__":
    main()
