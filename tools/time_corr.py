"""Time SDR's correlation kernels A4 (splits x4, x3, x1) and A10 on one CUDA card, alone or against another checkout.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_corr.py [--against DIR] [--rounds N] [--profile]

At SDR's main shape (64 x 16 s at 16 kHz; A10 also at 64 x (16 s + 100),
its padded variant) builds this checkout's kernel library and, with
``--against``, that of the checkout at DIR (for instance a parent commit
unpacked into a directory that git ignores), loads both into this one
process and launches their ``fsem_correlation_lags_gram`` and
``fsem_corr_fused`` entry points on the same inputs in turns: N rounds of
this, other, other, this, so that clocks and heat weigh on both alike. The
other checkout may have either interface of these entry points: the
float32 SIMT kernels (one slab partial per 4096 samples; A10 on the
float32 table in groups of 128 windows) or the tensor-core ones (bf16
halves, k ranges; A10 on the split table in groups of 127).

Prints the card's name and power limit, then one JSON line per case: the
median time of one launch of each library (CUDA events around each
launch, after warm-ups; ``device_ms`` the same with the card kept busy by
a sleep kernel queued before the start event, so that the host's time to
enqueue the launch is not counted), their ratio, the largest difference of each
library's result from the plain version over max|r_auto|, whether two
launches gave the same bits, and the least time of the tensor-core
products at 989 TFLOP/s (``tensor_ms``: 2 x 128 x 1280 x frames x rows per
bf16 term for A4, 2 x 3 x h x 2h per chunk row for A10). Last, the split
pass alone (``split_halves``) at the main shape. With ``--profile``, each
case's device time per kernel name from ``torch.profiler`` (5 launches).
Needs a CUDA card.
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

from fast_speech_enhancement_metrics_tpu_torch.ops import sdr_corr_fused, sdr_corr_gram  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12  # H100 SXM, dense, at the full 700 W limit
BATCH, RATE, LAGS = 64, 16000, 512
SPLITS = {"x4": 4, "x3": 3, "x1": 1}


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


def busy_event_ms(fn) -> float:
    """``event_ms`` with the card kept busy (a sleep kernel queued first)
    while the host enqueues ``fn``: the launches' device time alone."""
    torch.cuda._sleep(2_000_000)
    return event_ms(fn)


def profile(fn) -> dict:
    """Device time per kernel name (ms per call) over 5 calls."""
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in p.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t:
            out[e.key[:60]] = t / 5 / 1e3
    return out


def gram_call(lib, c, d, split):
    """A launch of ``fsem_correlation_lags_gram`` in ``lib``'s interface,
    its buffers made once; returns (call, (r_auto, r_cross))."""
    dev, (batch, t) = c.device, c.shape
    ra = torch.empty(batch, LAGS, device=dev)
    rc = torch.empty(batch, LAGS, device=dev)
    if len(lib._SIGNATURES["fsem_correlation_lags_gram"]) == 9:  # float32 SIMT: slab partials
        partial = torch.empty(batch, -(-t // 4096), 2, LAGS, device=dev)
        args = (c, d, partial, ra, rc, batch, t, SPLITS[split])
    else:
        frames = -(-t // 128)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        split_frames, n_ranges = sdr_corr_gram._gram_k_ranges(batch, frames, split, sms)
        halves = torch.empty(4, batch, frames * 128, device=dev, dtype=torch.bfloat16)
        partial = torch.empty(batch, n_ranges, 10, 2, 2, 128, device=dev)  # the larger of both layouts
        args = (c, d, halves, partial, ra, rc, batch, t, SPLITS[split], split_frames, n_ranges)
    return (lambda: lib.launch("correlation_lags_gram", dev, *args)), (ra, rc)


def fused_call(lib, c, d):
    """A launch of ``fsem_corr_fused`` in ``lib``'s interface, then the
    PyTorch tail (sum over groups, inverse DFT) on its partials."""
    dev, (batch, t) = c.device, c.shape
    chunks = -(-t // LAGS)
    if len(lib._SIGNATURES["fsem_corr_fused"]) == 9:  # float32 table, groups of 128
        groups = -(-chunks // 128)
        table = torch.from_numpy(sdr_corr_fused._packed_corr_matrix(LAGS)).to(dev)
        partial = torch.empty(batch, groups, 6, LAGS, device=dev)
        args = (c, d, table, partial, batch, t, LAGS, groups)
    else:
        groups = -(-chunks // sdr_corr_fused.KERNEL_WINDOWS)
        halves = torch.empty(4, batch, chunks * LAGS, device=dev, dtype=torch.bfloat16)
        table = sdr_corr_fused._table_halves(LAGS, dev)
        partial = torch.empty(batch, groups, 6, LAGS, device=dev)
        args = (c, d, halves, table, partial, batch, t, LAGS, groups)
    return (lambda: lib.launch("corr_fused", dev, *args)), partial


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--profile", action="store_true", help="device time per kernel name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_corr: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    order = ["this", "against", "against", "this"] if len(libs) == 2 else ["this"]
    dev = torch.device("cuda", 0)
    clean, noisy, _ = load_audio_data(16, BATCH, RATE)
    unaligned = load_audio_data(16 + 100 / RATE, BATCH, RATE)
    c, d = torch.from_numpy(clean).to(dev), torch.from_numpy(noisy).to(dev)
    cu, du = torch.from_numpy(unaligned[0]).to(dev), torch.from_numpy(unaligned[1]).to(dev)

    def normalised(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)

    cases = []
    for split in SPLITS:
        want = sdr_corr_gram._correlation_lags_plain(c, d, LAGS, split)
        calls = {name: gram_call(lib, c, d, split) for name, lib in libs.items()}
        tensor_ms = SPLITS[split] * 2 * 128 * 1280 * -(-c.shape[1] // 128) * BATCH / PEAK_BF16_TC_FLOPS * 1e3
        cases.append((f"A4-{split}" if split != "x4" else "A4", c.shape[1], calls, lambda out: out, want, tensor_ms))
    for kid, (cx, dx) in (("A10r", (c, d)), ("A10", (cu, du))):
        cn, dn = normalised(cx), normalised(dx)
        want = sdr_corr_fused._correlation_lags_fused_plain(cn, dn, LAGS)
        calls = {name: fused_call(lib, cn, dn) for name, lib in libs.items()}
        rows = -(-cn.shape[1] // LAGS) * 2
        tensor_ms = rows * BATCH * 2 * 3 * LAGS * 2 * LAGS / PEAK_BF16_TC_FLOPS * 1e3
        cases.append((kid, cn.shape[1], calls, lambda p: sdr_corr_fused._lags_from_partials(p, LAGS), want, tensor_ms))

    for kid, t, calls, result, want, tensor_ms in cases:
        row = {"id": kid, "rows": BATCH, "samples": t, "tensor_ms": tensor_ms}
        scale = want[0].abs().max().item()
        for name, (call, out) in calls.items():
            call()
            first = [x.clone() for x in result(out)]
            call()
            second = result(out)
            row[f"{name}_err"] = max((a - w).abs().max().item() for a, w in zip(first, want)) / scale
            row[f"{name}_bit_identical"] = all(torch.equal(a, b) for a, b in zip(first, second))
        for name in order:  # warm-ups
            calls[name][0]()
        torch.cuda.synchronize()
        times = {name: [] for name in libs}
        busy = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(event_ms(calls[name][0]))
                busy[name].append(busy_event_ms(calls[name][0]))
        for name in libs:
            row[f"{name}_ms"] = statistics.median(times[name])
            row[f"{name}_device_ms"] = statistics.median(busy[name])
            if args.profile:
                row[f"{name}_kernels_ms"] = profile(calls[name][0])
        if "against" in libs:
            row["this_over_against"] = row["this_ms"] / row["against_ms"]
        print(json.dumps(row), flush=True)

    for lo in (True, False):
        row_len = -(-c.shape[1] // 128) * 128
        ms = statistics.median([busy_event_ms(lambda: sdr_corr_gram.split_halves(c, d, row_len, lo))
                                for _ in range(args.rounds + 3)][3:])
        print(json.dumps({"id": "split_halves", "lo_planes": lo, "rows": BATCH, "samples": c.shape[1], "device_ms": ms,
                          "bytes_ms": BATCH * c.shape[1] * (8 + (8 if lo else 4)) / 3.35e12 * 1e3}), flush=True)


if __name__ == "__main__":
    main()
