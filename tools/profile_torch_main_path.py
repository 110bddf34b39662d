"""Where the time goes: the PyTorch/CUDA port's metrics under torch.profiler.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/profile_torch_main_path.py [--batch 64] [--seconds 16] [--only NAME ...]

For each of LSD, SDR, STOI(sample_rate=16000), PESQ, DNSMOS (also with its
trunk in bf16, "DNSMOS bf16") and SpeechBERTScore (at
mHuBERT-147's width with seeded random weights, ``init_params`` seed 0),
scores a batch of the package's synthetic audio (already on the card, as a
benchmark would hold it) a few times under ``torch.profiler`` and prints
one JSON line: the wall time per call, the device-busy time per call (the
sum of all kernel times), the device idle share, and the ten kernels with
the most device time. SpeechBERTScore is profiled again at the same batch
with ``attention_impl="layer_block"`` (each layer one launch of kernel A11,
A7's and A8's launches chained) and ``"block_int8"`` (the int8 attention
block A12, then the plain FFN),
on its long-audio path at 16 x 60 s (2999 frames, the attention on
kernel A9), and on one pair of 820 s clips (40 999 frames, kernel A15),
the last also at ``precision="highest"`` ("SpeechBERTScore highest": A15's
float32 arm and its split pass).
Each line also gives the share of device time of the attention kernel
(``flash_kernel``: A9, A15, A7's and so A11's; ``flash_f32_kernel``: A9's
and A15's float32 arm; ``i8_attention_kernel``: A12's), and the time of each kernel
in an anonymous namespace by its short name: the package's own (A7 and A8
are several: ``cast_kernel``, ``gemm_kernel<epilogue>``, ``flash_kernel``,
``residual_ln_kernel``; A12 adds the int8 ``gemm_kernel<3>`` and its
quantization passes)
and a few of PyTorch's. The first line is the card's name and power limit. Needs a CUDA
card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, PESQ, SDR, STOI, SpeechBERTScore  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import init_params  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data  # noqa: E402

CALLS = 5  # profiled calls per metric, after 3 warm-ups
LONG_BATCH, LONG_SECONDS = 16, 60  # SpeechBERTScore's long-audio run (A9)
FLASH_SECONDS = 820  # one pair past the sdpa range (A15)
ATTENTION_KERNELS = ("flash_kernel", "flash_f32_kernel", "i8_attention_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=16)
    ap.add_argument("--only", nargs="+", metavar="NAME",
                    help='profile only these runs, by the name in their line ("SpeechBERTScore block_int8")')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_main_path: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)

    def on_card(seconds, batch):
        clean, noisy, _ = load_audio_data(seconds, batch, 16000)
        return torch.from_numpy(clean).cuda(), torch.from_numpy(noisy).cuda()

    c, d = on_card(args.seconds, args.batch)
    params = init_params(torch.Generator().manual_seed(0))
    sbs = SpeechBERTScore(params=params)
    runs = [
        ("LSD", LSD(), c, d, args.batch, args.seconds),
        ("SDR", SDR(), c, d, args.batch, args.seconds),
        ("STOI", STOI(sample_rate=16000), c, d, args.batch, args.seconds),
        ("PESQ", PESQ(), c, d, args.batch, args.seconds),
        ("DNSMOS", DNSMOS(), c, d, args.batch, args.seconds),
        ("DNSMOS bf16", DNSMOS(conv_dtype=torch.bfloat16), c, d, args.batch, args.seconds),
        ("SpeechBERTScore", sbs, c, d, args.batch, args.seconds),
        ("SpeechBERTScore layer_block", SpeechBERTScore(params=params, attention_impl="layer_block"), c, d,
         args.batch, args.seconds),
        ("SpeechBERTScore block_int8", SpeechBERTScore(params=params, attention_impl="block_int8"), c, d,
         args.batch, args.seconds),
        ("SpeechBERTScore", sbs, *on_card(LONG_SECONDS, LONG_BATCH), LONG_BATCH, LONG_SECONDS),
        ("SpeechBERTScore", sbs, *on_card(FLASH_SECONDS, 1), 1, FLASH_SECONDS),
        ("SpeechBERTScore highest", SpeechBERTScore(params=params, precision="highest"),
         *on_card(FLASH_SECONDS, 1), 1, FLASH_SECONDS),
    ]
    for name, metric, c, d, batch, seconds in runs:
        if args.only and name not in args.only:
            continue
        for _ in range(3):
            metric(c, d)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                metric(c, d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
        kernels = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        ]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / CALLS
        per_name: dict[str, float] = {}
        for e in kernels:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total / 1e3 / CALLS
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        # kernels in an anonymous namespace (the package's csrc/ and a few of PyTorch's), by short name
        own = sorted(((k.split("(anonymous namespace)::", 1)[1].split("(", 1)[0], v) for k, v in per_name.items()
                      if "(anonymous namespace)::" in k), key=lambda kv: -kv[1])
        attention_ms = sum(v for k, v in per_name.items() if any(a in k for a in ATTENTION_KERNELS))
        print(json.dumps({
            "metric": name, "batch": batch, "seconds": seconds,
            "device": torch.cuda.get_device_name(0),
            "wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels_per_call": len(kernels) / CALLS,
            "attention_kernel_ms_per_call": attention_ms,
            "attention_kernel_share_of_busy": attention_ms / busy_ms,
            "top_kernels_ms_per_call": [[k[:90], v] for k, v in top],
            "own_kernels_ms_per_call": own,
        }), flush=True)


if __name__ == "__main__":
    main()
