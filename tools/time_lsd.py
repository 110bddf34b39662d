"""Time LSD's kernels (A1, A2, A3 and A13) on one CUDA card, alone or against another checkout.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_lsd.py [--against DIR] [--rounds N]

At LSD's main shapes (A1 and A13: 64 x 16 s at 16 kHz, raw pairs; A2:
64 x (16 s + 100) and A3: 64 x (20 s + 100), pre-scaled pairs) builds this
checkout's kernel library and, with ``--against``, that of the checkout at
DIR (for instance a parent commit unpacked into a directory that git
ignores), loads both into this one process and launches their
``fsem_lsd_wholesig_raw`` / ``fsem_lsd_wholesig`` / ``fsem_lsd_wholesig_ct``
entry points on the same inputs in turns: N rounds of this, other, other,
this, so that clocks and heat weigh on both alike. The other checkout may
have either interface of A1-A3's entry points: the float32 SIMT frame
kernel (a (256, 512) float32 table, 16-frame tile partials) or the
tensor-core one (bf16 pieces, the (3, 640, 256) tile table, (B, F, 5)
frame partials); A13's is the same in both (its tile partials sized here
for the smaller tiles of either, 8 frames).

Prints the card's name and power limit, then one JSON line per case: the
median time of one launch of each library (CUDA events around each launch,
after warm-ups; ``device_ms`` the same with the card kept busy by a sleep
kernel queued before the start event, so that the host's time to enqueue
the launch is not counted), their ratio, each library's largest difference
from the plain version, whether two launches gave the same bits, each
library's device time per kernel name from ``torch.profiler`` (5 launches:
for the tensor-core kernel the split pass, the tile kernel, the finalize
and A1's scale partials), and the least time of the bf16x6 tensor-core
products at 989 TFLOP/s (``tensor_ms``: 2 x 6 x 256 x 640 per chunk row,
128 chunk rows per group of 127 frames, both signals) and of the split
pass's bytes at 3.35 TB/s (``split_bytes_ms``: 8 read and 12 written per
sample pair); for A13 the least time of the signals' bytes
(``bytes_ms``) and of its FFT's float32 operations at 67 TFLOP/s
(``fft_ops_ms``: ``ops/lsd_fused.py::CT_FFT_OPS`` per chunk and signal,
64 chunks a tile of 63 frames). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import lsd_fused  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _chunk_rdft_matrix_packed  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data  # noqa: E402
from time_corr import PEAK_BF16_TC_FLOPS, busy_event_ms, event_ms, kernel_library, profile  # noqa: E402

PEAK_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12
BATCH, RATE, HOP, EPS = 64, 16000, 256, 1e-8


def lsd_call(lib, c, d, raw: bool):
    """A launch of A1's (``raw``) or A2/A3's entry point in ``lib``'s
    interface, its buffers made once; returns (call, scores)."""
    dev, (batch, t) = c.device, c.shape
    out = torch.empty(batch, device=dev)
    frames = 1 + t // HOP
    name = "fsem_lsd_wholesig_raw" if raw else "fsem_lsd_wholesig"
    simt = len(lib._SIGNATURES[name]) == (10 if raw else 9)
    if simt:  # float32 table, tiles of 16 frames
        table = torch.from_numpy(_chunk_rdft_matrix_packed(2 * HOP)).to(dev)
        head = (c, d, table)
        partial = torch.empty(batch, -(-frames // 16), device=dev)
    else:
        pieces = torch.empty(6, batch, -(-t // HOP) * HOP, device=dev, dtype=torch.bfloat16)
        head = (c, d, pieces, lsd_fused._tile_table_pieces(dev))
        partial = torch.empty(batch, frames, 5, device=dev)
    if raw:
        scale_partial = torch.empty(batch, 16, 2, device=dev)
        args = (*head, scale_partial, partial, out, batch, t // HOP, EPS)
    else:
        args = (*head, partial, out, batch, t, EPS)
    return (lambda: lib.launch(name[len("fsem_"):], dev, *args)), out


def ct_call(lib, c, d):
    """A launch of A13's entry point in ``lib``, the projection scale
    computed by the kernel; returns (call, scores)."""
    dev, (batch, t) = c.device, c.shape
    nc = t // HOP
    tw, w0, _ = (torch.from_numpy(a).to(dev) for a in lsd_fused._ct_constants())
    scale_partial = torch.empty(batch, 16, 2, device=dev)
    partial = torch.empty(batch, -(-(nc + 1) // 8), device=dev)
    out = torch.empty(batch, device=dev)
    return (lambda: lib.launch("lsd_wholesig_ct", dev, c, d, None, tw, w0, scale_partial, partial, out, batch, nc,
                               EPS)), out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_lsd: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    order = ["this", "against", "against", "this"] if len(libs) == 2 else ["this"]
    dev = torch.device("cuda", 0)
    long_c, long_d, _ = load_audio_data(20 + 100 / RATE + 0.01, BATCH, RATE)
    long_c, long_d = torch.from_numpy(long_c).to(dev), torch.from_numpy(long_d).to(dev)

    def prescaled(cx, dx):
        return (dx * (torch.sum(cx * dx, dim=1, keepdim=True) / (torch.sum(dx * dx, dim=1, keepdim=True) + EPS))
                ).contiguous()

    cases = []
    for kid, n in (("A1", 16 * RATE), ("A2", 16 * RATE + 100), ("A3", 20 * RATE + 100)):
        c, d = long_c[:, :n].contiguous(), long_d[:, :n].contiguous()
        raw = kid == "A1"
        if raw:
            want = lsd_fused._lsd_wholesig_raw_plain(c, d, HOP, EPS)
        else:
            d = prescaled(c, d)
            want = lsd_fused._lsd_wholesig_plain(c, d, HOP, EPS)
        frames = 1 + n // HOP
        rows = -(-frames // 127) * 128
        tensor_ms = 2 * BATCH * rows * 2 * 6 * HOP * 640 / PEAK_BF16_TC_FLOPS * 1e3
        split_ms = BATCH * -(-n // HOP) * HOP * 20 / PEAK_BYTES * 1e3
        cases.append((kid, n, {name: lsd_call(lib, c, d, raw) for name, lib in libs.items()}, want,
                      {"tensor_ms": tensor_ms, "split_bytes_ms": split_ms}))
    n = 16 * RATE
    c, d = long_c[:, :n].contiguous(), long_d[:, :n].contiguous()
    tiles = -(-(n // HOP + 1) // lsd_fused._CT_TILE_FRAMES)
    cases.append(("A13", n, {name: ct_call(lib, c, d) for name, lib in libs.items()},
                  lsd_fused._lsd_wholesig_ct_plain(c, d, HOP, EPS),
                  {"bytes_ms": (2 * BATCH * n * 4 + BATCH * 4) / PEAK_BYTES * 1e3,
                   "fft_ops_ms": 2 * BATCH * tiles * 64 * lsd_fused.CT_FFT_OPS / PEAK_FP32_FLOPS * 1e3}))

    for kid, n, calls, want, bounds in cases:
        row = {"id": kid, "rows": BATCH, "samples": n, **bounds}
        for name, (call, out) in calls.items():
            call()
            first = out.clone()
            call()
            row[f"{name}_err"] = (first - want).abs().max().item()
            row[f"{name}_bit_identical"] = torch.equal(first, out)
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
            row[f"{name}_kernels_ms"] = profile(calls[name][0])
        if "against" in libs:
            row["this_over_against"] = row["this_device_ms"] / row["against_device_ms"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
