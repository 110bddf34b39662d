#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Usage, from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``) and the TF32 switches;
   float32 matmuls must not use TF32,
2. build the CUDA kernels from ``csrc/`` (``nvcc``, sm_90a),
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (64 x 16 s x 16 kHz from the package's synthetic
   generator),
4. the main path: ``LSD()``, ``SDR()`` and ``STOI(sample_rate=16000)``
   through ``__call__`` on that batch, with every kernel's launch count
   read around it, and the first rows scored again on the CPU (plain
   path) for agreement,
5. times: each kernel, its plain version, a PyTorch library call for the
   same function where one exists, and each metric end to end,
6. the result: a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, SECONDS, RATE = 64, 16, 16000
CPU_ROWS = 4
HOP, EPS, LAGS = 256, 1e-8, 512
#: published H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
PACKAGE = "fast_speech_enhancement_metrics_tpu_torch"
JAX_PACKAGE = "fast_speech_enhancement_metrics_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median wall time of ``fn()`` in ms; ``fn`` ends in a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for the work on this card, and which side sets it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rfft_flops(n: int) -> float:
    """Operations of one n-point real FFT (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def sdr_db(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    coh = torch.sum(b * x, dim=-1)
    return 10.0 * torch.log10(torch.clamp(coh / torch.clamp(1.0 - coh, min=1e-8), min=1e-8))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import fast_speech_enhancement_metrics_tpu_torch as pkg
    from fast_speech_enhancement_metrics_tpu_torch.ops import (
        cuda_lib,
        levinson_pallas,
        lsd_fused,
        sdr_corr_gram,
        stoi_fused,
        toeplitz,
    )
    from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    dev = torch.device("cuda", 0)

    # -- 1. card and precision switches ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls would use TF32")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_lib.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for src in cuda_lib.SOURCES:
        text = (cuda_lib.BUILD_DIR / f"{src.rsplit('.', 1)[0]}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------------
    clean_np, noisy_np, _ = load_audio_data(SECONDS, BATCH, RATE)
    c = torch.from_numpy(clean_np).to(dev)
    d = torch.from_numpy(noisy_np).to(dev)
    t_len = c.shape[1]
    results = {}

    def record(kid, name, src, replaces, err, tol, note=""):
        log(f"{kid} {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}){note}")
        check(math.isfinite(err) and err <= tol, f"{kid} {name} disagrees with its plain version")
        results[kid] = {
            "name": name, "id": kid, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{src}",
            "replaces": f"{JAX_PACKAGE}/ops/{replaces}",
            "max_abs_err": err, "tolerance": tol,
        }

    # A1: LSD scores, atol 2e-4 (the metric's contract without its rtol part)
    lsd_k = lsd_fused.lsd_wholesig_raw(c, d, HOP, EPS)
    lsd_p = lsd_fused._lsd_wholesig_raw_plain(c, d, HOP, EPS)
    err = torch.max(torch.abs(lsd_k - lsd_p)).item()
    record("A1", lsd_fused.KERNEL, "lsd_fused.cu", "lsd_fused.py:208", err, 2e-4)

    # A4: correlations of the raw signals, atol 2e-4 * max|r_auto|
    ra_k, rc_k = sdr_corr_gram.correlation_lags_gram(c, d, LAGS)
    ra_p, rc_p = sdr_corr_gram._correlation_lags_plain(c, d, LAGS)
    scale = torch.max(torch.abs(ra_p)).item()
    err = max(torch.max(torch.abs(ra_k - ra_p)).item(), torch.max(torch.abs(rc_k - rc_p)).item())
    record("A4", sdr_corr_gram.KERNEL, "sdr_corr_gram.cu", "sdr_corr_gram.py:57", err, 2e-4 * scale)

    # A5: the 512-tap SDR systems of those correlations; the solutions are
    # held at 2e-3 of max|x| (the tests' Levinson tolerance at n = 512) and
    # through the SDR they give, at the metric's 1e-2 dB
    nc2 = torch.clamp(ra_p[:, :1], min=1e-12)
    nd2 = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-12)
    r0n = (ra_p / nc2).contiguous()
    bn = (rc_p / torch.sqrt(nc2 * nd2)).contiguous()
    x_k = levinson_pallas.levinson_solve_fused(r0n, bn)
    x_p = toeplitz.levinson_solve(r0n, bn)
    err = torch.max(torch.abs(sdr_db(bn, x_k) - sdr_db(bn, x_p))).item()
    rel_x = (torch.max(torch.abs(x_k - x_p)) / torch.max(torch.abs(x_p))).item()
    check(math.isfinite(rel_x) and rel_x <= 2e-3,
          f"A5 solution differs from its plain version by {rel_x:.2e} of max|x| (tolerance 2e-3)")
    record("A5", levinson_pallas.KERNEL, "levinson.cu", "levinson_pallas.py:38", err, 1e-2,
           f" dB of SDR; solution max diff {rel_x:.2e} of max|x| (tolerance 2e-3)")

    # A6: segment sums of the STOI front end's envelopes, atol 5e-4 per
    # segment after the metric's division
    stoi_metric = pkg.STOI(sample_rate=RATE)
    c10, d10 = resample(c, RATE, 10000), resample(d, RATE, 10000)
    tob_c, tob_d, nseg = stoi_metric._envelopes(c10, d10)
    s_k, e_k = stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg)
    s_p, e_p = stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15)
    per = torch.clamp(nseg, min=1).float()
    err = max(torch.max(torch.abs(s_k - s_p) / 15 / per).item(),
              torch.max(torch.abs(e_k - e_p) / 30 / per).item())
    record("A6", stoi_fused.KERNEL, "stoi_fused.cu", "stoi_fused.py:59", err, 5e-4)

    # -- 4. main path -----------------------------------------------------------
    metrics = {
        "LSD": pkg.LSD(),
        "SDR": pkg.SDR(),
        "STOI": pkg.STOI(sample_rate=RATE),
    }
    kernel_of = {"A1": lsd_fused.KERNEL, "A4": sdr_corr_gram.KERNEL,
                 "A5": levinson_pallas.KERNEL, "A6": stoi_fused.KERNEL}
    torch.cuda.synchronize()
    cuda_lib.launch_counts.clear()
    scores = {name: m(clean_np, noisy_np) for name, m in metrics.items()}
    torch.cuda.synchronize()
    counts = dict(cuda_lib.launch_counts)
    log(f"main path launches: {counts}")
    for kid, kname in kernel_of.items():
        check(counts.get(kname, 0) >= 1, f"{kid} {kname} was not launched on the main path")
        results[kid]["launches"] = counts[kname]

    cpu_tol = {"LSD": ("rel", 2e-4), "SDR": ("abs", 1e-2), "STOI": ("abs", 5e-4)}
    for name, rows in scores.items():
        check(len(rows) == BATCH, f"{name}: {len(rows)} results for {BATCH} rows")
        vals = np.array([[v for v in r.values()] for r in rows])
        check(bool(np.all(np.isfinite(vals))), f"{name}: non-finite scores")
        cpu_metric = type(metrics[name])(device="cpu", **({"sample_rate": RATE} if name == "STOI" else {}))
        cpu_rows = cpu_metric(clean_np[:CPU_ROWS], noisy_np[:CPU_ROWS])
        kind, tol = cpu_tol[name]
        worst = 0.0
        for gpu_r, cpu_r in zip(rows[:CPU_ROWS], cpu_rows):
            for key, want in cpu_r.items():
                diff = abs(gpu_r[key] - want)
                limit = tol + (tol * abs(want) if kind == "rel" else 0.0)
                check(diff <= limit, f"{name}.{key}: card {gpu_r[key]} vs CPU {want}")
                worst = max(worst, diff)
        mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        log(f"{name}: batch mean {mean}; card vs CPU plain path on {CPU_ROWS} rows: "
            f"max diff {worst:.3e} ({'rtol/atol' if kind == 'rel' else 'atol'} {tol})")

    # -- 5. times ---------------------------------------------------------------
    nc = t_len // HOP
    idx = torch.as_tensor(np.abs(np.arange(LAGS)[None, :] - np.arange(LAGS)[:, None]), device=dev)
    toeplitz_full = r0n[:, idx]
    # r[l] = sum_k y[k + l] c[k]: a grouped conv1d of the right-padded
    # targets with the lagged signal as the filter gives lags 0..LAGS-1
    pairs = torch.nn.functional.pad(torch.cat([c, d], dim=0)[None], (0, LAGS - 1))
    lagged = torch.cat([c, c], dim=0)[:, None]  # (2B, 1, T)

    def corr_library():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.nn.functional.conv1d(pairs, lagged, groups=2 * BATCH)

    n_seg_total = float(nseg.sum().item())
    f_len = tob_c.shape[1]
    # Operation counts. "ops" is the least the function needs: FFT-level
    # counts for the spectra and correlations (log and sqrt one operation
    # each). "direct" is what the kernel's own algorithm does, where that is
    # more: A1's chunk DFT as a 256 x 512 product, A4's direct 512-lag sums.
    frames = nc + 1
    a1_ops = (2 * BATCH * frames * (rfft_flops(2 * HOP) + 2 * HOP)  # windowed 512-point spectra
              + BATCH * frames * (HOP + 1) * 14  # |C|^2 / (|D| + eps)^2, log, square, sum
              + 4 * BATCH * t_len)  # projection-scale sums
    a1_direct = 2 * BATCH * nc * HOP * 2 * HOP * 2 + 4 * BATCH * t_len
    k_blocks = -(-t_len // LAGS)  # overlap-save as in ops/dft.py::correlation_lags
    a4_ops = BATCH * ((2 * k_blocks + 1) * rfft_flops(2 * LAGS)  # chunk spectra of c and d
                      + k_blocks * (LAGS + 1) * (4 + 2 * 8)  # window combine, two products
                      + 2 * rfft_flops(2 * LAGS))  # two inverse transforms
    a4_direct = 2 * BATCH * t_len * LAGS * 2
    a5_ops = 12 * LAGS * (LAGS - 1) * BATCH  # per step: two dot products, four axpys
    # per valid segment: ~30 flops per (band, frame) over 15 x 30, plus ~15
    # per frame for the ESTOI band normalisation
    a6_ops = n_seg_total * 30 * (15 * 30 + 15)
    timing = {
        "A1": (lambda: lsd_fused.lsd_wholesig_raw(c, d, HOP, EPS),
               lambda: lsd_fused._lsd_wholesig_raw_plain(c, d, HOP, EPS), None,
               a1_ops, a1_direct, 2 * BATCH * t_len * 4 + HOP * 2 * HOP * 4 + BATCH * 4),
        "A4": (lambda: sdr_corr_gram.correlation_lags_gram(c, d, LAGS),
               lambda: sdr_corr_gram._correlation_lags_plain(c, d, LAGS), corr_library,
               a4_ops, a4_direct, 2 * BATCH * t_len * 4 + 2 * BATCH * LAGS * 4),
        "A5": (lambda: levinson_pallas.levinson_solve_fused(r0n, bn),
               lambda: toeplitz.levinson_solve(r0n, bn),
               lambda: torch.linalg.solve(toeplitz_full, bn[..., None]),
               a5_ops, a5_ops, 3 * BATCH * LAGS * 4),
        "A6": (lambda: stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg),
               lambda: stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15), None,
               a6_ops, a6_ops, 2 * BATCH * f_len * 15 * 4 + BATCH * 4 + 2 * BATCH * 4),
    }
    for kid, (kern, plain, library, ops, direct_ops, nbytes) in timing.items():
        r = results[kid]
        r["ms"] = cuda_ms(kern)
        r["plain_ms"] = cuda_ms(plain, warmup=1, reps=10)
        r["library_ms"] = None if library is None else cuda_ms(library, warmup=1, reps=10)
        r["bound_ms"], r["bound_by"] = bound(ops, nbytes)
        r["direct_bound_ms"], _ = bound(direct_ops, nbytes)
        log(f"{kid} {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; {r['direct_bound_ms']:.4f} ms for the kernel's own algorithm), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")

    audio_s = BATCH * SECONDS
    for name, m in metrics.items():
        ms = host_ms(lambda m=m: m(c, d))
        log(json.dumps({"metric": name, "batch": BATCH, "seconds": SECONDS, "ms": ms,
                        "audio_seconds_per_s": audio_s / (ms / 1e3)}))
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 6. result ---------------------------------------------------------------
    keys = ("name", "id", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "direct_bound_ms",
            "library_ms")
    log(json.dumps({"kernels": [{k: results[kid][k] for k in keys} for kid in sorted(results)]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
