"""Time kernel A12 (the int8 attention block) and each of its launches at the main path's shape.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_attn_block_int8.py [DIR]

On one mHuBERT-147 layer (d 768, 12 heads of 64) with seeded random
weights, at SpeechBERTScore's 64 x 16 s shape (64 rows of 799 frames), for
the softmax modes "exp2" and "exact": the median time of one
``attn_block(..., quant="int8")`` call (CUDA events around each of 10
calls after 3 warm-ups), its largest difference from the plain version,
and the device time of its six longest kernels per call under
``torch.profiler`` (5 calls), as one JSON line each. DIR (default: this
checkout) is the root of the checkout whose package is loaded, so that a
copy of the package with an edited kernel can be timed the same way. The
first line is the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import attn_block_pallas, cuda_lib  # noqa: E402

D, HEADS, ROWS, FRAMES = 768, 12, 64, 799


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_attn_block_int8: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    layer = {n: rnd(D, D, scale=0.06 if n in ("q_w", "k_w") else 0.02) for n in ("q_w", "k_w", "v_w", "o_w")}
    layer.update({n: rnd(D, scale=0.02) for n in ("q_b", "k_b", "v_b", "o_b")})
    layer.update(ln1_s=1 + rnd(D, scale=0.1), ln1_b=rnd(D, scale=0.1))
    x = rnd(ROWS, FRAMES, D, scale=1.0)
    for mode in ("exp2", "exact"):
        packed = attn_block_pallas.pack_attn_block_params(layer, HEADS, mode, quant="int8")

        def call():
            return attn_block_pallas.attn_block(x, packed, HEADS, 1e-5, mode, quant="int8")

        want = attn_block_pallas._attn_block_int8_plain(x, packed, HEADS, 1e-5, mode)
        err = (call() - want).abs().max().item()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        per_kernel: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                per_kernel[name] = per_kernel.get(name, 0.0) + e.device_time_total / 1e3 / 5
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({"softmax": mode, "device": torch.cuda.get_device_name(0), "ms": statistics.median(times),
                          "max_abs_err": err, "kernels_ms_per_call": top}), flush=True)


if __name__ == "__main__":
    main()
