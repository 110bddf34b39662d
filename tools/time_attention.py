"""Time the long-audio attention kernels A9 and A15 on one CUDA card, alone or against another checkout.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_attention.py [--against DIR] [--rounds N]

Builds this checkout's kernel library and, with ``--against``, that of the
checkout at DIR (for instance a parent commit unpacked into a directory
that git ignores), loads both into this one process and launches their
``fsem_sdpa`` entry points on the same inputs in turns: N rounds of this,
other, other, this, so that clocks and heat weigh on both alike. Prints
the card's name and power limit, then one JSON line per case: the shape,
the softmax mode, the median time of one launch of each library (CUDA
events around each launch, after warm-ups), their ratio, and the least
time the bf16 tensor cores need for 4 T^2 D operations per (row, head) at
989 TFLOP/s. ``chip_smoke.py`` times the library yardstick beside the
kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import sdpa_pallas  # noqa: E402

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


def kernel_library(root: Path, tag: str):
    """The ``cuda_lib`` module of the checkout at ``root``, loaded under its
    own name, its library built from that checkout's sources."""
    path = root / "fast_speech_enhancement_metrics_tpu_torch" / "ops" / "cuda_lib.py"
    spec = importlib.util.spec_from_file_location(f"cuda_lib_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build()
    return module


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--rounds", type=int, default=10, help="rounds per case (A15: a quarter of them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    order = ["this", "against", "against", "this"] if len(libs) == 2 else ["this"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kid, mode, b, h, t, d in CASES:
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).mul_(1.2).to(torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        if kid == "A15":  # as sdpa_pallas.flash_sdpa launches it
            n_keys = -(-t // sdpa_pallas.FLASH_KEY_QUANTUM) * sdpa_pallas.FLASH_KEY_QUANTUM
            launch_args = (q, k, v, out, b, h, t, n_keys, d, 3, d**-0.5, 0.0)
        else:  # as sdpa_pallas.sdpa launches it
            qs = sdpa_pallas._scaled_q(q, d**-0.5, mode)
            launch_args = (qs, k, v, out, b, h, t, t, d, sdpa_pallas.SOFTMAX_MODES.index(mode), 1.0,
                           sdpa_pallas._pad_keys_l(t, mode))
        calls = {name: (lambda lib=lib: lib.launch("sdpa", dev, *launch_args)) for name, lib in libs.items()}
        rounds = max(1, args.rounds // 4) if kid == "A15" else args.rounds
        for name in order:  # warm-ups
            calls[name]()
        torch.cuda.synchronize()
        times = {name: [] for name in libs}
        for _ in range(rounds):
            for name in order:
                times[name].append(event_ms(calls[name]))
        row = {"id": kid, "softmax": mode, "shape": [b, h, t, d],
               "bound_ms": 4 * b * h * t * t * d / PEAK_BF16_TC_FLOPS * 1e3,
               "launches_each": len(order) // len(libs) * rounds}
        for name in libs:
            row[f"{name}_ms"] = statistics.median(times[name])
        if "against" in libs:
            row["this_over_against"] = row["this_ms"] / row["against_ms"]
        print(json.dumps(row), flush=True)
        del q, k, v, out


if __name__ == "__main__":
    main()
