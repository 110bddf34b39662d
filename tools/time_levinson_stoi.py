"""Time SDR's Levinson solve (A5, the A14 variants) and STOI's segment kernel (A6) on one CUDA card, alone or against another checkout.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_levinson_stoi.py [--against DIR] [--rounds N]

At the main shapes (SDR's 64 x 512 Toeplitz systems of the 64 x 16 s
batch at 16 kHz; STOI's envelopes of the same batch) builds this
checkout's kernel library and, with ``--against``, that of the checkout at
DIR (for instance a parent commit unpacked into a directory that git
ignores), loads both into this one process and launches their
``fsem_levinson_solve`` (every variant) and ``fsem_stoi_segment_sums``
entry points on the same inputs in turns: N rounds of this, other, other,
this, so that clocks and heat weigh on both alike. Then ``SDR()`` and
``STOI(sample_rate=16000)`` end to end, in the same turns, with each
library in place of the package's.

Prints the card's name and power limit, then one JSON
line per case: the median time of one launch of each library (CUDA events
around each launch, after warm-ups; ``device_ms`` the same with the card
kept busy by a sleep kernel queued before the start event, so that the
host's time to enqueue the launch is not counted), their ratio, each
library's largest difference from the plain version (of max|x| for the
Levinson solves; per segment after the metric's division for A6), whether
two launches gave the same bits, each library's device time per kernel
name from ``torch.profiler`` (5 launches), and for A5 whether this
checkout's result is its warp-order reference bit for bit.
The end-to-end lines give the median wall time of one call (inputs on the
card, ending in the scores' copy to the host) and this checkout's device
time per kernel name in the call; the last line times STOI's band matmul
(the power spectrum times the third-octave matrix, the op before A6)
alone. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import fast_speech_enhancement_metrics_tpu_torch as pkg  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops import (  # noqa: E402
    cuda_lib,
    levinson_pallas,
    sdr_corr_gram,
    stoi_fused,
)
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import framed_rdft_center_half  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data  # noqa: E402
from time_corr import busy_event_ms, event_ms, kernel_library, profile  # noqa: E402

BATCH, SECONDS, RATE, LAGS = 64, 16, 16000, 512


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def host_ms(fn, warmup: int = 3, reps: int = 1) -> list[float]:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_levinson_stoi: needs a CUDA card")
    print(smi("name,power.limit"), flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    dev = torch.device("cuda", 0)

    clean, noisy, _ = load_audio_data(SECONDS, BATCH, RATE)
    c, d = torch.from_numpy(clean).to(dev), torch.from_numpy(noisy).to(dev)
    # SDR's systems, as chip_smoke.py builds them
    ra, rc = sdr_corr_gram._correlation_lags_plain(c, d, LAGS)
    nc2 = torch.clamp(ra[:, :1], min=1e-12)
    nd2 = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-12)
    r0n = (ra / nc2).contiguous()
    bn = (rc / torch.sqrt(nc2 * nd2)).contiguous()
    # STOI's envelopes
    tob_c, tob_d, nseg = pkg.STOI(sample_rate=RATE)._envelopes(resample(c, RATE, 10000), resample(d, RATE, 10000))
    nseg = nseg.to(torch.int32).contiguous()
    f_len = tob_c.shape[1]
    per = torch.clamp(nseg, min=1).float()
    a5_reference = levinson_pallas._levinson_warp_order_reference(r0n, bn)

    def levinson_call(lib, variant):
        x = torch.empty_like(r0n)
        vid = levinson_pallas.VARIANTS.index(variant)
        return (lambda: lib.launch("levinson_solve", dev, r0n, bn, x, BATCH, LAGS, vid)), x

    def stoi_call(lib):
        # room for the partials of either checkout's tiling (64 or 128 segments)
        partial = torch.empty(BATCH * -(-f_len // 64) * 2, device=dev)
        out = torch.empty(BATCH, 2, device=dev)
        return (lambda: lib.launch("stoi_segment_sums", dev, tob_c, tob_d, nseg, partial, out, BATCH, f_len)), out

    cases = []
    for variant in levinson_pallas.VARIANTS:
        kid = "A5" if variant == "vpu" else f"A14-{variant}"
        want = levinson_pallas._plain(variant)(r0n, bn)
        calls = {name: levinson_call(lib, variant) for name, lib in libs.items()}
        cases.append((kid, calls, lambda x, want=want: ((x - want).abs().max() / want.abs().max()).item()))
    s_p, e_p = stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15)
    calls = {name: stoi_call(lib) for name, lib in libs.items()}
    cases.append(("A6", calls, lambda out: max(((out[:, 0] - s_p) / 15 / per).abs().max().item(),
                                               ((out[:, 1] - e_p) / 30 / per).abs().max().item())))

    for kid, calls, err in cases:
        row = {"id": kid, "rows": BATCH, **({"frames": f_len} if kid == "A6" else {"order": LAGS})}
        firsts = {}
        for name, (call, out) in calls.items():
            call()
            first = out.clone()
            call()
            firsts[name] = first
            row[f"{name}_err"] = err(first)
            row[f"{name}_bit_identical"] = torch.equal(first, out)
        if kid == "A5":
            row["this_is_reference"] = torch.equal(firsts["this"], a5_reference)
        names = list(calls)
        order = names + names[::-1]
        for name in order:  # warm-ups
            calls[name][0]()
        torch.cuda.synchronize()
        times = {name: [] for name in names}
        busy = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(event_ms(calls[name][0]))
                busy[name].append(busy_event_ms(calls[name][0]))
        for name in names:
            row[f"{name}_ms"] = statistics.median(times[name])
            row[f"{name}_device_ms"] = statistics.median(busy[name])
            row[f"{name}_kernels_ms"] = profile(calls[name][0])
        if "against" in calls:
            row["this_over_against"] = row["this_device_ms"] / row["against_device_ms"]
        print(json.dumps(row), flush=True)

    # end to end, each library in place of the package's
    own = cuda_lib._library()
    order = list(libs) + list(libs)[::-1]
    for name, metric in (("SDR", pkg.SDR()), ("STOI", pkg.STOI(sample_rate=RATE))):
        times = {lib: [] for lib in libs}
        for lib in order:  # warm-ups
            cuda_lib._lib = libs[lib]._library()
            host_ms(lambda: metric(c, d), warmup=2, reps=0)
        for _ in range(args.rounds):
            for lib in order:
                cuda_lib._lib = libs[lib]._library()
                times[lib] += host_ms(lambda: metric(c, d), warmup=0, reps=1)
        cuda_lib._lib = own
        row = {"metric": name, "batch": BATCH, "seconds": SECONDS}
        for lib in libs:
            row[f"{lib}_ms"] = statistics.median(times[lib])
        if "against" in libs:
            row["this_over_against"] = row["this_ms"] / row["against_ms"]
        row["this_kernels_ms"] = profile(lambda: metric(c, d))
        print(json.dumps(row), flush=True)

    # STOI's band matmul, the op before A6, alone: the (2B, frames, bins)
    # power spectrum times the (bins, 15) third-octave matrix
    stoi = pkg.STOI(sample_rate=RATE)
    c_sig, d_sig, _ = stoi._remove_silent_frames(resample(c, RATE, 10000), resample(d, RATE, 10000))
    re, im = framed_rdft_center_half(torch.cat([c_sig, d_sig]), stoi.n_fft, stoi.hop, window=stoi.stft_window,
                                     n_bins=stoi.dft_bins)
    power = re * re + im * im
    band = lambda: power @ stoi._obm_t  # noqa: E731
    for _ in range(3):
        band()
    print(json.dumps({"id": "STOI band matmul", "shape": [*power.shape, stoi._obm_t.shape[1]],
                      "ms": statistics.median(event_ms(band) for _ in range(args.rounds)),
                      "device_ms": statistics.median(busy_event_ms(band) for _ in range(args.rounds)),
                      "kernels_ms": profile(band)}), flush=True)


if __name__ == "__main__":
    main()
