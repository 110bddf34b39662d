"""Time the long-audio attention kernels A9 and A15, both arms, on one CUDA card, alone or against another checkout.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_attention.py [--against DIR] [--rounds N] [--only ID ...]

Builds this checkout's kernel library and, with ``--against``, that of the
checkout at DIR (for instance a parent commit unpacked into a directory
that git ignores), loads both into this one process and launches their
``fsem_sdpa`` entry points on the same inputs in turns: N rounds of this,
other, other, this, so that clocks and heat weigh on both alike. The
float32 cases (``precision="highest"``) launch the split pass
``fsem_sdpa_f32_split`` and then ``fsem_sdpa_f32`` as the wrapper does
(a checkout from before the bf16x6 arm has neither: leave them out with
``--only``). Prints the card's name and power limit, then one JSON line
per case: the shape, the softmax mode, the median time of one launch of
each library (CUDA events around each launch, after warm-ups; float32:
the split pass and the kernel, and the split pass alone beside its byte
bound at 3.35 TB/s), their ratio, whether the two libraries' outputs are
equal bit for bit (and their largest difference), and the least time for
the case's operations on the bf16 tensor cores at 989 TFLOP/s: 4 T^2 D
per (row, head), six times that for the float32 arm's bf16x6 products. With ``--against``, it first
compares the SASS of the bf16 ``flash_kernel`` instantiations (A9, A15
and A7's attention, so A11's) in the two libraries (``cuobjdump``).
``chip_smoke.py`` times the library yardstick beside the kernels. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import sdpa_pallas  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12  # H100 SXM, dense, at the full 700 W limit
PEAK_BYTES = 3.35e12  # HBM3
#: (kernel id, softmax mode, batch, heads, frames, head width): SpeechBERTScore's
#: 16 x 60 s path (A9, its three modes), heads of 80 (HuBERT-xlarge) and one
#: 820 s pair (A15); then the float32 arms at the shapes chip_smoke.py times
CASES = (
    ("A9", "exp2", 16, 12, 2999, 64),
    ("A9", "exp2_bf16", 16, 12, 2999, 64),
    ("A9", "exact", 16, 12, 2999, 64),
    ("A9", "exp2", 4, 16, 1499, 80),
    ("A15", "online", 2, 12, 40999, 64),
    ("A9-f32", "exact", 16, 12, 2999, 64),
    ("A15-f32", "online", 2, 12, 40999, 64),
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


def flash_sass(lib) -> dict[str, str]:
    """The SASS of each bf16 ``flash_kernel`` instantiation in the library
    of the checkout whose ``cuda_lib`` module is ``lib``, by its mangled
    name from ``flash_kernel`` on (the anonymous namespace's part of the
    name hashes its source file)."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(lib._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib.library_path())], capture_output=True, text=True,
                          check=True).stdout
    funcs = (f.split("\n", 1) for f in sass.split("Function : ")[1:])
    return {re.search(r"flash_kernel\w*", name).group(0): body for name, body in funcs if "flash_kernel" in name}


def attention_calls(lib, dev, f32: bool, q, k, v, out, args):
    """One launch as ``sdpa_pallas._launch`` makes it with the checkout's
    library ``lib``, and (float32) its split pass alone, else None:
    ``args`` = (batch, heads, frames, keys walked, head width, mode, scale,
    l_pad)."""
    if not f32:
        return (lambda: lib.launch("sdpa", dev, q, k, v, out, *args)), None
    b, h, t, _, d = args[:5]
    pieces = torch.empty(3, 3, b * h * t, sdpa_pallas._head_box(d), dtype=torch.bfloat16, device=dev)

    def split():
        lib.launch("sdpa_f32_split", dev, q, k, v, pieces, b * h * t, d, sdpa_pallas._head_box(d))

    def call():
        split()
        lib.launch("sdpa_f32", dev, pieces, out, *args)

    return call, split


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
    ap.add_argument("--only", nargs="+", metavar="ID", help="time only these cases (A9, A15, A9-f32, A15-f32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    order = ["this", "against", "against", "this"] if len(libs) == 2 else ["this"]
    if "against" in libs:
        this_sass, other_sass = flash_sass(libs["this"]), flash_sass(libs["against"])
        print(json.dumps({"flash_kernel_instantiations": len(this_sass),
                          "sass_equal": this_sass == other_sass}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kid, mode, b, h, t, d in CASES:
        if args.only and kid not in args.only:
            continue
        f32 = kid.endswith("-f32")
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).mul_(1.2).to(torch.bfloat16) for _ in range(3))
        if f32:  # the bf16 values in float32, as chip_smoke.py times this arm
            q, k, v = (a.float() for a in (q, k, v))
        if kid.startswith("A15"):  # as sdpa_pallas.flash_sdpa launches it
            n_keys = -(-t // sdpa_pallas.FLASH_KEY_QUANTUM) * sdpa_pallas.FLASH_KEY_QUANTUM
            launch_args = (b, h, t, n_keys, d, 3, d**-0.5, 0.0)
        else:  # as sdpa_pallas.sdpa launches it
            q = sdpa_pallas._scaled_q(q, d**-0.5, mode)
            launch_args = (b, h, t, t, d, sdpa_pallas.SOFTMAX_MODES.index(mode), 1.0,
                           sdpa_pallas._pad_keys_l(t, mode))
        outs = {name: torch.empty_like(q) for name in libs}
        calls = {name: attention_calls(lib, dev, f32, q, k, v, outs[name], launch_args) for name, lib in libs.items()}
        rounds = max(1, args.rounds // 4) if kid.startswith("A15") else args.rounds
        for name in order:  # warm-ups
            calls[name][0]()
        torch.cuda.synchronize()
        times = {name: [] for name in libs}
        split_times = {name: [] for name in libs}
        for _ in range(rounds):
            for name in order:
                times[name].append(event_ms(calls[name][0]))
                if f32:
                    split_times[name].append(event_ms(calls[name][1]))
        row = {"id": kid, "softmax": mode, "shape": [b, h, t, d],
               "bound_ms": (6 if f32 else 1) * 4 * b * h * t * t * d / PEAK_BF16_TC_FLOPS * 1e3,
               "launches_each": len(order) // len(libs) * rounds}
        for name in libs:
            row[f"{name}_ms"] = statistics.median(times[name])
            if f32:
                row[f"{name}_split_ms"] = statistics.median(split_times[name])
        if f32:  # q, k, v read once in float32, their three bf16 pieces written once
            row["split_bound_ms"] = 3 * b * h * t * (4 * d + 3 * 2 * sdpa_pallas._head_box(d)) / PEAK_BYTES * 1e3
        if "against" in libs:
            row["this_over_against"] = row["this_ms"] / row["against_ms"]
            row["outputs_bit_equal"] = torch.equal(outs["this"], outs["against"])
            row["outputs_max_abs_diff"] = torch.max(torch.abs(outs["this"].float() - outs["against"].float())).item()
        print(json.dumps(row), flush=True)
        del q, k, v, outs, calls


if __name__ == "__main__":
    main()
