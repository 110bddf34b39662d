"""Time the conv encoder's kernels (conv_gelu, conv_ln_gelu, conv0_ln_gelu) against cuDNN float32 on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_conv_gelu.py [--rows 64] [--reps 5] [--norm none|layer]

Builds the package's kernel library, then for each conv of the encoder at
the shape of ``rows`` clips of 16 s (conv 1 reads 512 x 51 199 frames), with
a GELU output of that shape as input and He-scaled weights: the median time
of one kernel launch and of the plain version, CUDA events around each call
after a warm-up, beside the least time of the conv's work and the share of
it that the kernel reaches. ``--norm none`` (mHuBERT-147's convs 1-6):
``ops/conv_gelu.py::conv_gelu`` (tanh GELU, the weights' pieces made
before) against cuDNN float32 with TF32 off, then ``F.gelu``; the bound is
the conv's operations in the kernel's class (six bf16 products per float32
one at 989 TFLOP/s). ``--norm layer`` (WavLM-Large's layer-norm encoder,
LayerNorm scale 1 + N(0, 0.01), shift N(0, 0.01)): conv 0 on
``conv0_ln_gelu`` (speech-scaled samples; its bound the bytes it reads and
writes at 3.35 TB/s) and convs 1-6 on ``conv_ln_gelu`` (also FE's launch
without the LayerNorm, ``none_ms``), against cuDNN float32, then
``numerics.layer_norm`` over channels, then the GELU. On the first two rows,
each one's largest distance from a float64 chain over the float64 output's
largest magnitude. Prints the card's name and power limit, one JSON line per
conv and one with the sums. Needs a CUDA card.
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
from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, cuda_lib, numerics  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SECONDS, RATE = 16, 16000
EPS = 1e-5


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


def float64_chain(x, w, stride, norm):
    """conv, the LayerNorm over channels where ``norm`` holds (scale,
    shift), and the tanh GELU, in float64."""
    y = F.conv1d(x.double(), w.double(), stride=stride)
    if norm is not None:
        mean = y.mean(dim=1, keepdim=True)
        y = (y - mean) * torch.rsqrt(((y - mean) ** 2).mean(dim=1, keepdim=True) + EPS)
        y = y * norm[0].double()[:, None] + norm[1].double()[:, None]
    return numerics.gelu(y, "tanh")


def record(rec: dict, kernel, plain, x, w, stride, norm, reps: int) -> dict:
    rec["kernel_ms"] = event_ms(lambda: kernel(x), reps)
    rec["cudnn_ms"] = event_ms(lambda: plain(x), reps)
    rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
    want = float64_chain(x[:2], w, stride, norm)
    for name, fn in (("kernel", kernel), ("cudnn", plain)):
        rec[f"{name}_from_float64"] = ((fn(x[:2]).double() - want).abs().max() / want.abs().max()).item()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--norm", choices=("none", "layer"), default="none")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_conv_gelu: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    cfg = MHUBERT_147_CONFIG  # WavLM-Large's conv widths are the same
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = args.norm == "layer"
    sums = {"kernel_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}

    def norm_params(c):
        return 1 + 0.1 * torch.randn(c, device=dev, generator=gen), 0.1 * torch.randn(c, device=dev, generator=gen)

    def emit(rec):
        for key in sums:
            sums[key] += rec[key]
        print(json.dumps(rec), flush=True)

    t_in = SECONDS * RATE
    if layer:  # conv 0: one input channel, width 10, stride 5
        c_out, k, stride = cfg.conv_dim[0], cfg.conv_kernel[0], cfg.conv_stride[0]
        x = 0.1 * torch.randn(args.rows, 1, t_in, device=dev, generator=gen)
        w = torch.randn(c_out, 1, k, device=dev, generator=gen) * (2.0 / k) ** 0.5
        norm = norm_params(c_out)
        t_out = (t_in - k) // stride + 1
        rec = {"conv": 0, "norm": "layer", "width": k, "frames_in": t_in, "rows": args.rows,
               "bound_ms": 4 * args.rows * (t_in + c_out * t_out) / PEAK_BYTES * 1e3}
        rec = record(rec, lambda x_: conv_gelu.conv0_ln_gelu(x_, w, *norm, EPS, "tanh"),
                     lambda x_: conv_gelu._conv_ln_gelu_plain(x_, w, *norm, EPS, "tanh", stride), x, w, stride, norm,
                     args.reps)
        emit(rec)
        del x
        torch.cuda.empty_cache()
    t_in = (t_in - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    for i in range(1, len(cfg.conv_kernel)):
        c_in, c_out, k = cfg.conv_dim[i - 1], cfg.conv_dim[i], cfg.conv_kernel[i]
        x = F.gelu(torch.randn(args.rows, c_in, t_in, device=dev, generator=gen))
        w = torch.randn(c_out, c_in, k, device=dev, generator=gen) * (c_in * k) ** -0.5
        pieces = conv_gelu.split_pieces(w)
        t_out = (t_in - k) // 2 + 1
        rec = {"conv": i, "norm": args.norm, "width": k, "frames_in": t_in, "rows": args.rows,
               "bound_ms": 6 * 2 * args.rows * t_out * c_out * c_in * k / PEAK_BF16_TC_FLOPS * 1e3}
        if layer:
            norm = norm_params(c_out)
            rec["none_ms"] = event_ms(lambda: conv_gelu.conv_gelu(x, w, "tanh", pieces=pieces), args.reps)
            rec = record(rec, lambda x_: conv_gelu.conv_ln_gelu(x_, w, *norm, EPS, "tanh", pieces=pieces),
                         lambda x_: conv_gelu._conv_ln_gelu_plain(x_, w, *norm, EPS, "tanh", 2), x, w, 2, norm,
                         args.reps)
        else:
            rec = record(rec, lambda x_: conv_gelu.conv_gelu(x_, w, "tanh", pieces=pieces),
                         lambda x_: conv_gelu._conv_gelu_plain(x_, w, "tanh"), x, w, 2, None, args.reps)
        emit(rec)
        t_in = t_out
        del x
        torch.cuda.empty_cache()
    sums["share_of_bound"] = sums["bound_ms"] / sums["kernel_ms"]
    print(json.dumps({"convs": "0-6" if layer else "1-6", "norm": args.norm, **sums}))


if __name__ == "__main__":
    main()
