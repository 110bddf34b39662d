"""Time the conv encoder's convs 1-6 on their kernel (conv_gelu) against cuDNN float32, conv by conv, on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_conv_gelu.py [--rows 64] [--reps 5]

Builds the package's kernel library, then for each of mHuBERT-147's convs
1-6 at the shape of ``rows`` clips of 16 s (conv 1 reads 512 x 51 199
frames), with a GELU output of that shape as input and He-scaled weights:
the median time of one kernel launch (``ops/conv_gelu.py::conv_gelu``,
tanh GELU, the weights' pieces made before) and of the plain version
(cuDNN float32 with TF32 off, then ``F.gelu``), CUDA events around each
call after a warm-up, beside the least time of the conv's operations in
the kernel's class (six bf16 products per float32 one at 989 TFLOP/s) and
its share of that bound. On the first two rows, each one's largest
distance from a float64 conv over the float64 output's largest magnitude.
Prints the card's name and power limit, one JSON line per conv and one
with the sums. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.models.hubert import MHUBERT_147_CONFIG  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, cuda_lib  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12
SECONDS, RATE = 16, 16000


def event_ms(fn, reps: int) -> float:
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
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_conv_gelu: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    cfg = MHUBERT_147_CONFIG
    gen = torch.Generator(device=dev).manual_seed(0)
    t_in = (SECONDS * RATE - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    sums = {"kernel_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}
    for i in range(1, len(cfg.conv_kernel)):
        c_in, c_out, k = cfg.conv_dim[i - 1], cfg.conv_dim[i], cfg.conv_kernel[i]
        x = F.gelu(torch.randn(args.rows, c_in, t_in, device=dev, generator=gen))
        w = torch.randn(c_out, c_in, k, device=dev, generator=gen) * (c_in * k) ** -0.5
        pieces = conv_gelu.split_pieces(w)
        t_out = (t_in - k) // 2 + 1
        bound_ms = 6 * 2 * args.rows * t_out * c_out * c_in * k / PEAK_BF16_TC_FLOPS * 1e3
        rec = {"conv": i, "width": k, "frames_in": t_in, "rows": args.rows,
               "kernel_ms": event_ms(lambda: conv_gelu.conv_gelu(x, w, "tanh", pieces=pieces), args.reps),
               "cudnn_ms": event_ms(lambda: conv_gelu._conv_gelu_plain(x, w, "tanh"), args.reps),
               "bound_ms": bound_ms}
        rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
        want = conv_gelu._gelu(F.conv1d(x[:2].double(), w.double(), stride=2), "tanh")
        for name, got in (("kernel", conv_gelu.conv_gelu(x[:2], w, "tanh", pieces=pieces)),
                          ("cudnn", conv_gelu._conv_gelu_plain(x[:2], w, "tanh"))):
            rec[f"{name}_from_float64"] = ((got.double() - want).abs().max() / want.abs().max()).item()
        for key in sums:
            sums[key] += rec[key]
        print(json.dumps(rec), flush=True)
        t_in = t_out
        del x, want
        torch.cuda.empty_cache()
    sums["share_of_bound"] = sums["bound_ms"] / sums["kernel_ms"]
    print(json.dumps({"convs": "1-6", **sums}))


if __name__ == "__main__":
    main()
