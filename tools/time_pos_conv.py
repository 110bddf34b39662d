"""Time the positional conv stage on its kernel (pos_conv) against cuDNN float32 and the stage's passes, on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_pos_conv.py [--reps 5] [--only mhubert wavlm long]

Builds the package's kernel library and prints ptxas's lines for
``pos_conv.cu``. Then, at the shapes the SpeechBERTScore cells run (one
row chunk: 64 x 799 frames x 768 channels with the BN affine, as
mHuBERT-147; 64 x 799 x 1024 without, as WavLM-Large; 16 x 2999 x 768 with
it, mHuBERT-147 on 60 s rows; 16 groups, width 128), with N(0, 1) inputs,
weights N(0, 1 / (128 c_g)), bias N(0, 0.01) and BN scale 1 + N(0, 0.09),
shift N(0, 0.09): the median time of one kernel launch
(``ops/pos_conv.py::pos_conv``, the weights' pieces made before) and of the
plain version (cuDNN float32 with TF32 off over transposed views, the
trim, + b, GELU, + x), CUDA events around each call after a warm-up,
beside the least time of the conv's operations in the kernel's class (six
bf16 products per float32 one at 989 TFLOP/s) and its share of that bound.
On the first two rows (and on 2 x 37 frames), the largest distance of each
from a float64 stage over the float64 output's largest magnitude, and
whether two launches are bit-equal. Prints the card's name and power limit
and one JSON line per shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, pos_conv  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12
GROUPS = 16
#: name -> (rows, frames, channels, BN affine)
SHAPES = {"mhubert": (64, 799, 768, True), "wavlm": (64, 799, 1024, False), "long": (16, 2999, 768, True)}


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


def operands(rows: int, frames: int, channels: int, bn: bool, dev: torch.device, seed: int = 0) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(seed)
    cg = channels // GROUPS
    x = torch.randn(rows, frames, channels, device=dev, generator=gen)
    w = torch.randn(channels, cg, pos_conv.WIDTH, device=dev, generator=gen) * (cg * pos_conv.WIDTH) ** -0.5
    b = 0.1 * torch.randn(channels, device=dev, generator=gen)
    scale = 1 + 0.3 * torch.randn(channels, device=dev, generator=gen) if bn else None
    shift = 0.3 * torch.randn(channels, device=dev, generator=gen) if bn else None
    return x, w, b, scale, shift


def from_float64(x, w, b, scale, shift, rows: int = 2) -> dict:
    """Distances of the kernel and of cuDNN float32 from a float64 stage on
    ``rows`` rows, over the float64 output's largest magnitude; two kernel
    launches bit-equal."""
    x = x[:rows].contiguous()
    pieces = pos_conv.split_pieces(w, GROUPS)
    pos_in = x if scale is None else x * scale + shift
    conv = F.conv1d(pos_in.double().transpose(1, 2), w.double(), padding=pos_conv.WIDTH // 2, groups=GROUPS)
    want = x.double() + F.gelu(conv.transpose(1, 2)[:, :-1] + b.double())
    got = pos_conv.pos_conv(x, w, b, GROUPS, scale, shift, pieces=pieces)
    again = pos_conv.pos_conv(x, w, b, GROUPS, scale, shift, pieces=pieces)
    lib = pos_conv._pos_conv_plain(x, w, b, GROUPS, scale, shift)
    top = want.abs().max()
    return {"kernel_from_float64": ((got.double() - want).abs().max() / top).item(),
            "cudnn_from_float64": ((lib.double() - want).abs().max() / top).item(),
            "kernel_vs_cudnn": ((got - lib).abs().max() / lib.abs().max()).item(),
            "twice_equal": bool(torch.equal(got, again))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=list(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_pos_conv: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    so = cuda_lib.build()
    log = (cuda_lib.BUILD_DIR / "pos_conv.log").read_text()
    for line in log.splitlines():
        if any(key in line for key in ("entry function", "registers", "spill", "C75", "wgmma", "arning")):
            print(f"ptxas pos_conv.cu: {line.strip()}", flush=True)
    # the consumers' setmaxnreg draws on the block's registers at launch: 640 x 96
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    if len(regs) != 2 or min(regs) < 96:
        sys.exit(f"time_pos_conv: pos_conv_kernel holds {regs} registers a thread at launch, not 96")
    print(f"library {so.name}", flush=True)
    dev = torch.device("cuda", 0)
    # small shapes first: both widths, BN on and off, an odd and an even length
    for channels in (768, 1024):
        for bn in (True, False):
            for frames in (37, 300):
                rec = {"rows": 2, "frames": frames, "channels": channels, "bn": bn,
                       **from_float64(*operands(2, frames, channels, bn, dev, seed=frames))}
                print(json.dumps(rec), flush=True)
    for name in args.only:
        rows, frames, channels, bn = SHAPES[name]
        x, w, b, scale, shift = operands(rows, frames, channels, bn, dev)
        pieces = pos_conv.split_pieces(w, GROUPS)
        cg = channels // GROUPS
        bound_ms = 6 * 2 * rows * frames * channels * cg * pos_conv.WIDTH / PEAK_BF16_TC_FLOPS * 1e3
        before = cuda_lib.launch_counts[pos_conv.KERNEL]
        rec = {"shape": name, "rows": rows, "frames": frames, "channels": channels, "bn": bn,
               "kernel_ms": event_ms(lambda: pos_conv.pos_conv(x, w, b, GROUPS, scale, shift, pieces=pieces),
                                     args.reps),
               "cudnn_ms": event_ms(lambda: pos_conv._pos_conv_plain(x, w, b, GROUPS, scale, shift), args.reps),
               "bound_ms": bound_ms}
        rec["launches"] = cuda_lib.launch_counts[pos_conv.KERNEL] - before
        rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
        rec.update(from_float64(x, w, b, scale, shift))
        print(json.dumps(rec), flush=True)
        del x, w, pieces
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
