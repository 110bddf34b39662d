#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Usage, from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``) and the TF32 switches;
   float32 matmuls must not use TF32, nor the metrics' convs (HuBERT's
   and DNSMOS's),
2. build the CUDA kernels from ``csrc/`` (``nvcc``, sm_90a) and print each
   kernel's registers and spills (``ptxas -v``), and any wgmma
   serialization warning; the attention kernel of A9, A15 and A7 (A11) and
   the GEMM of A7 and A8 (A11) must hold bf16 wgmma (HGMMA) and TMA
   (UTMALDG) instructions in the SASS of every instantiation
   (``cuobjdump``), so must the float32 arm of A9 and A15 (bf16x6 on the
   same tensor cores), A12's int8 GEMM and int8 attention int8 wgmma (IGMMA)
   and TMA, SDR's correlation kernels (A4's Gram in splits x4, x3, x1 and
   A10's chunk DFT) and LSD's frame-tile kernel (A1-A3) bf16 wgmma and
   TMA, so must the conv encoder's convs 1-6 (``conv_gelu.cu``, both
   widths and GELUs) bf16 wgmma and TMA,
   and none may spill a register, nor may the Levinson warp kernels
   (A5 and the A14 variants, all 32 orders each) or A6's segment kernel,
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (64 x 16 s x 16 kHz from the package's synthetic
   generator; 64 x (16 s + 100) and 64 x (20 s + 100) samples for LSD's
   A2 and A3; A1-A3 also on near-clean pairs (speech + 1e-3 max|speech|
   noise; A1 from three noise seeds), two launches bit-equal, and their distance from a float64
   reference printed beside the plain version's; A4 in its split modes x3 and x1 against the plain
   correlation summed over the bf16 halves, x4 (the four-term bf16 class)
   against the float32 correlation, its distance printed; the split pass
   of A4 and A10 bit for bit; one mHuBERT-147 layer at 64 x
   799 frames for A7 and A8, and A7
   at 8 x 799 with heads of 32, 80, 96 and 12; A9 at 16 x 12 heads x 2999 frames x
   64 in its three softmax modes in bf16 and "exact" in float32, and at
   4 x 16 heads x 1499 x 80; A15 at 2 x 12 x 40 999 x 64, also in float32;
   the float32 arms also on 128 queries against a float64 softmax, and
   their split pass bit for bit; A10 at 64 x 16 s
   and 64 x (16 s + 100); A13 at 64 x 16 s, also against A1 and on A1's
   three near-clean pairs, within 2e-4 of a float64 LSD, twice bit-equal;
   each A14 Levinson variant on the 64 x 512 systems that SDR builds from
   the 16 s batch, bit for bit its torch twin and twice bit-equal
   ("dotreduce" also A5 bit for bit); A5 also bit for bit its warp-order
   reference, at n = 1024 on 4 rows, and A5 and A6 twice bit-equal; A6 also on ragged segment counts
   (0, mid-tile, full); A11 and A12 on A7's mHuBERT-147 layer in every softmax mode, A11
   also against A7 then A8 bit for bit, A12 also in the JAX package's int8
   screening class against A7; A12's int8 GEMM alone exactly against its
   plain version at the layer's QKV and W_o products; FE, convs 1-6 of
   mHuBERT-147's conv encoder on ``conv_gelu.cu``, at 64 x 16 s against
   their plain version (cuDNN float32, TF32 off, then the GELU), conv 1
   on two rows also against a float64 conv, within twice cuDNN's distance),
4. the main paths, each with every kernel's launch count set to 0 before
   it and read after it: ``LSD()``, ``SDR()`` and
   ``STOI(sample_rate=16000)`` through ``__call__`` on the 16 s batch;
   ``LSD()`` on the two unaligned batches; ``SpeechBERTScore`` at
   mHuBERT-147's full width with seeded random weights on the 16 s batch
   (A7, A8, and FE six launches a row chunk; ``attention_impl="layer_block"``: A11, its F1 equal to A7 +
   A8's; ``"block_int8"``: A12),
   on 16 x 60 s (A9) and on one pair of 820 s clips (A15), and each at
   ``precision="highest"`` (one 60 s pair: A9's float32 arm; the 820 s
   pair: A15's, within 2e-3 of the bf16 path);
   ``SDR(corr_impl="fused")`` on the 16 s and 16 s + 100 batches (A10);
   ``SDR(corr_impl="gram")`` and ``"gram_x1"`` on the 16 s batch (A4 in
   split x3 and x1);
   ``lsd_scores(..., dft_impl="ct")`` on the 16 s batch (A13);
   ``levinson_solve_fused(..., variant=v)`` for each A14 variant;
   ``PESQ()`` and ``DNSMOS()`` on the 16 s batch (no kernel on either path:
   none may launch), ``DNSMOS`` also at ``precision="highest"``, with
   ``conv_dtype=torch.bfloat16`` (within 0.04 / 0.04 / 0.02 of it) and
   ``window_plan="per_window"`` on the first rows (1e-4 of shared_exact),
   ``PESQ(time_align=True)`` on the batch delayed by 1200 samples (every row
   shifted back exactly).
   The first rows are scored again on the CPU (plain path) for agreement,
   and SpeechBERTScore's also by the card's float32 path (the 820 s pair:
   by the exact A9 path); fused SDR also against ``SDR()``.
   Then the API that has no kernel of its own: ``ops/stft.py``'s ``stft``
   and ``spectrogram`` (power 1 and 2) on the 16 s batch, ``n_fft=512`` at
   ``hop=256, center=True`` and at ``hop=160, win_length=400``, against
   the same call on the CPU (1e-5 of max|Z|); ``SpeechBERTScore(checkpoint=
   ...)`` from a ``save_params`` file of the seeded weights, on the 16 s
   batch: A7 and A8 as often as the ``params=`` route, its F1 bit-equal,
5. times: each kernel (CUDA events around one call; also its device time
   alone, the card kept busy while the host enqueues it), its plain
   version (A5 and each A14 variant also beside its chain's floor, an
   estimate at an assumed latency, on its log line only), a PyTorch
   library call (or, for
   A7, A8 and A11, a composite of library calls) for the same function where
   one exists (none computes int8 attention: A12's ``library_ms`` is null,
   and its ``library_partial_ms`` is ``torch._int_mm`` with the
   dequantization for its QKV and W_o products only); the GEMM of A7 and A8
   alone at the layer's four products against bf16 ``F.linear``, A12's
   int8 GEMM alone at QKV and W_o against ``torch._int_mm`` and the
   dequantization; FE's six convs in a chain from a 64 x 16 s conv 0
   output, against the same chain on cuDNN; A9's and A15's float32 arms (``precision="highest"``)
   on their float32 inputs, against scaled_dot_product_attention's
   memory-efficient backend, and their split pass; and each metric end to
   end (SpeechBERTScore also on
   16 x 60 s, one 820 s pair at ``precision="highest"``, and with
   ``attention_impl`` "layer_block" and "block_int8",
   SDR also with ``corr_impl`` "fused", "gram" and "gram_x1"; PESQ, also
   with ``time_align=True``, and DNSMOS, also with a bf16 trunk, each with
   its peak device memory); conv 0 and the feature encoder alone on the
   16 s clean rows, with FE's launches a call, for the record,
6. the bench harness (``benchmarking/runner.py``): the calibration canary
   and its graph-protocol twin, each at or below 1.1 x the card's bf16
   peak; ``bench_one`` for each of ``make_metrics()``'s six at 64 x 16 s
   with a short budget, one record a line: each on the CUDA graph protocol,
   the graph's captured launches equal to one eager call's, A1, A4, A5, A6,
   A7 and A8 among them, the replays' scores the eager call's,
7. the mesh (``parallel/``): a one-rank NCCL group on 127.0.0.1 and
   ``create_mesh(1, 1)``; the six metrics with ``mesh=`` against the same
   metrics without it: phase 4's limits, the same launch counts; the group
   destroyed after,
8. the result: a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

BATCH, SECONDS, RATE = 64, 16, 16000
CPU_ROWS = 4
SBS_CPU_ROWS = 2
HOP, EPS, LAGS = 256, 1e-8, 512
#: unaligned clip lengths for LSD's A2 (F + 1 <= 1024 frames) and A3 (beyond)
A2_SAMPLES, A3_SAMPLES = 16 * RATE + 100, 20 * RATE + 100
#: PESQ(time_align=True)'s injected delay: 75 ms, inside its +-100 ms search
SHIFT = 1200
#: SpeechBERTScore's long-audio paths: 16 x 60 s (2999 frames, A9) and one
#: pair of 820 s clips (40 999 frames, A15)
LONG_BATCH, LONG_SECONDS, FLASH_SECONDS = 16, 60, 820
#: the bench harness's time budget per metric in phase 6 (seconds)
HARNESS_BUDGET_S = 1.0
#: the kernels each bench metric's path must launch (phases 6 and 7)
HARNESS_KERNELS = {"LSD": ("A1",), "SDR": ("A4", "A5"), "STOI": ("A6",), "SpeechBERTScore": ("A7", "A8"),
                   "PESQ": (), "DNSMOS": ()}
#: the graph's replays against the eager call (phase 6): phase 4's limits
#: (LSD's rtol 2e-4 on scores below 10 as an atol)
HARNESS_TOL = {"LSD": 2e-3, "SDR": 1e-2, "STOI": 5e-4, "PESQ": 1e-3, "DNSMOS": 5e-4, "SpeechBERTScore": 2e-4}
#: a metric on a one-rank mesh against itself without one (phase 7): phase 4's limits
MESH_TOL = {"LSD": ("rel", 2e-4), "SDR": ("abs", 1e-2), "STOI": ("abs", 5e-4), "PESQ": ("abs", 1e-3),
            "DNSMOS": ("abs", 5e-4), "SpeechBERTScore": ("abs", 2e-4)}
#: seeds of the generators that A9's and A15's checks draw from
A9_SEED, A15_SEED = 9, 10
#: published H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_TC_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_INT8_TC_OPS = 1979e12  # int8 tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3
PACKAGE = "fast_speech_enhancement_metrics_tpu_torch"
JAX_PACKAGE = "fast_speech_enhancement_metrics_tpu"


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(title: str) -> None:
    """Mark the start of a phase with the seconds since the script started."""
    log(f"== {title} at {time.perf_counter() - T0:.1f} s")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, warmup: int = 3, reps: int = 10, busy: bool = False) -> float:
    """Median time of ``fn()`` in ms (CUDA events around each call). With
    ``busy``, a sleep kernel queued before each start event keeps the card
    busy while the host enqueues ``fn``: its launches' device time alone,
    without the host's time to enqueue them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if busy:
            torch.cuda._sleep(2_000_000)
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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the work on this card, and which side sets it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: assumed dependent-issue latency of a float32 add, multiply or FMA, and
#: the least for any instruction, in SM cycles (CUDA C++ Programming Guide,
#: "Multiprocessor Level": 4 cycles for most arithmetic instructions since
#: compute capability 7.x); not measured here
FP32_LATENCY_CYCLES = 4


def chain_floor_ms(n: int, sm_clock_hz: float, variant: str = "vpu") -> float:
    """An estimate, not a measurement, of the least time the n - 1
    dependent steps of a Levinson kernel take on one SM at ``sm_clock_hz``,
    each operation at the assumed ``FP32_LATENCY_CYCLES``. A5 ("vpu") and
    the "flat" kernels, per step: a product, the ceil(log2 n)-level add
    tree of the dot product, 1 - ef^2 (one FMA), a correctly rounded
    reciprocal (an approximation and two Newton FMAs) and the update's two
    dependent products (v' = (g - ef u) r, then r1 v' of the next step).
    "dotreduce": one more, the broadcast after its split tree. "double",
    per round of two steps: the product and the tree, 1 - ef1^2, the
    reciprocal, ef2 = rho1 (...), 1 - ef2^2, the second reciprocal, then
    u2 = (...) rho2 and y2 = (...) + mu2 u2; the last step alone as A5's."""
    tree = (n - 1).bit_length()
    step = 1 + tree + 1 + 3 + 2
    if variant == "dotreduce":
        step += 1
    if variant != "double":
        return (n - 1) * step * FP32_LATENCY_CYCLES / sm_clock_hz * 1e3
    rounds = (n - 1) // 2
    ops = rounds * (1 + tree + 1 + 3 + 1 + 1 + 3 + 2) + (n - 1) % 2 * step
    return ops * FP32_LATENCY_CYCLES / sm_clock_hz * 1e3


def rfft_flops(n: int) -> float:
    """Operations of one n-point real FFT (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def sdr_db(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    coh = torch.sum(b * x, dim=-1)
    return 10.0 * torch.log10(torch.clamp(coh / torch.clamp(1.0 - coh, min=1e-8), min=1e-8))


def bench_harness_phase(results: dict, single: dict, clean_np: np.ndarray, noisy_np: np.ndarray,
                        device=None) -> None:
    """Phase 6: the canary and each of the bench's six factories through
    ``benchmarking/runner.py`` with a short budget: the graph protocol (none
    runs a host plan), the graph's captured launches equal one eager
    call's, the replays' scores the eager call's; the launch counts set to
    0 before each metric. Each factory's scores also against phase 4's
    metric of that name (``single``): the same configuration within phase
    4's limits, DNSMOS's bf16 trunk within its bf16 class, SpeechBERTScore's
    bf16 activations printed. ``results``: the kernels' records (their
    names)."""
    from fast_speech_enhancement_metrics_tpu_torch.benchmarking import runner
    from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib

    phase("bench harness")
    t_phase = time.perf_counter()
    canary = runner.calibration_canary(device)
    log(json.dumps({"metric": "_canary", **canary}))
    peak = 1.1 * runner.H100_PEAK_BF16_TFLOPS
    check(canary["canary_ok"] and canary["canary_tflops"] <= peak and canary["canary_scan_tflops"] <= peak,
          f"timing canary {canary['canary_tflops']} / {canary['canary_scan_tflops']} TFLOP/s above 1.1 x "
          f"{runner.H100_PEAK_BF16_TFLOPS}")
    for name, factory in runner.make_metrics(RATE, device).items():
        metric = factory()
        check(getattr(metric, "host_chunk", None) is None, f"{name}: the bench factory runs a host plan")
        torch.cuda.synchronize()
        cuda_lib.launch_counts.clear()
        rec = runner.bench_one(name, metric, clean_np, noisy_np, clean_np.shape[1] // RATE,
                               time_budget_s=HARNESS_BUDGET_S)
        log(json.dumps(rec))
        check(rec["protocol"] == "graph", f"{name}: protocol {rec['protocol']}, expected the CUDA graph")
        check(rec["graph_launches"] == rec["launches"],
              f"{name}: the graph captured launches {rec['graph_launches']}, one eager call {rec['launches']}")
        for kid in HARNESS_KERNELS[name]:
            kname = results[kid]["name"]
            check(rec["launches"].get(kname, 0) >= 1, f"{kid} {kname} was not launched on the {name} bench path")
        dev = rec["scan_vs_eager_max_abs"]
        check(math.isfinite(dev) and dev <= HARNESS_TOL[name],
              f"{name}: the graph's scores vs the eager call's {dev:.3e} (atol {HARNESS_TOL[name]})")
        clean_in = None if metric.NON_INTRUSIVE else clean_np
        got, want = (np.array([list(r.values()) for r in m_(clean_in, noisy_np)]) for m_ in (metric, single[name]))
        vs_phase4 = np.max(np.abs(got - want), axis=0)
        if name == "DNSMOS":  # the bf16 trunk against float32
            check(bool(np.all(vs_phase4 <= np.array([0.04, 0.04, 0.02]))),
                  f"DNSMOS bench factory (bf16 trunk) vs float32 {vs_phase4.tolist()} (atol 0.04 / 0.04 / 0.02)")
        elif name != "SpeechBERTScore":
            check(float(vs_phase4.max()) <= HARNESS_TOL[name], f"{name} bench factory vs phase 4 {vs_phase4.tolist()}")
        log(f"{name} bench factory vs phase 4's {name}: max diff {vs_phase4.tolist()}")
        del metric
        torch.cuda.empty_cache()
    log(f"bench harness: {time.perf_counter() - t_phase:.1f} s")


def mesh_phase(pkg, results: dict, single: dict, sbs_params: dict, clean_np: np.ndarray, noisy_np: np.ndarray,
               device_type: str = "cuda") -> None:
    """Phase 7: a one-rank group on 127.0.0.1 (NCCL on the card) and
    ``create_mesh(1, 1)``; each metric of ``single`` (name -> the metric
    without a mesh) against the same metric with ``mesh=``: the scores
    within phase 4's limits, the same launch counts. One card holds one
    rank: the data all-gather and tensor parallelism run in the CPU tests'
    gloo groups."""
    from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
    from fast_speech_enhancement_metrics_tpu_torch.parallel import create_mesh, initialize_distributed

    phase("mesh")
    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", LOCAL_RANK="0", WORLD_SIZE="1")
    initialize_distributed(device_type)
    try:
        mesh = create_mesh(1, 1, device_type=device_type)
        log(f"mesh: {mesh} on backend {dist.get_backend()}")
        make = {
            "LSD": lambda: pkg.LSD(mesh=mesh),
            "SDR": lambda: pkg.SDR(mesh=mesh),
            "STOI": lambda: pkg.STOI(sample_rate=RATE, mesh=mesh),
            "PESQ": lambda: pkg.PESQ(mesh=mesh),
            "DNSMOS": lambda: pkg.DNSMOS(mesh=mesh),
            "SpeechBERTScore": lambda: pkg.SpeechBERTScore(params=sbs_params, mesh=mesh),
        }
        for name, metric in single.items():
            sharded = make[name]()
            kind, tol = MESH_TOL[name]
            clean_in = None if metric.NON_INTRUSIVE else clean_np
            counts, rows = [], []
            for m_ in (metric, sharded):
                torch.cuda.synchronize()
                cuda_lib.launch_counts.clear()
                rows.append(m_(clean_in, noisy_np))
                torch.cuda.synchronize()
                counts.append(dict(cuda_lib.launch_counts))
            check(counts[1] == counts[0], f"{name} on the mesh launched {counts[1]}, without one {counts[0]}")
            for kid in HARNESS_KERNELS[name]:
                check(counts[1].get(results[kid]["name"], 0) >= 1, f"{kid} was not launched by {name} on the mesh")
            want, got = (np.array([list(r.values()) for r in rows_]) for rows_ in rows)
            check(got.shape == want.shape == (len(noisy_np), len(rows[0][0])) and bool(np.all(np.isfinite(got))),
                  f"{name} on the mesh: bad scores")
            excess = float(np.max(np.abs(got - want) - (tol * np.abs(want) if kind == "rel" else 0.0)))
            check(excess <= tol, f"{name} on the mesh vs one device beyond {kind} {tol}")
            log(f"mesh {name}: launches {counts[1]} (as without a mesh); max diff vs one device "
                f"{float(np.max(np.abs(got - want))):.3e} ({kind} {tol})")
            del sharded
    finally:
        dist.destroy_process_group()
    log(f"mesh: {time.perf_counter() - t_phase:.1f} s")


def public_api_phase(pkg, sbs, sbs_params: dict, f1: np.ndarray, clean_np: np.ndarray, noisy_np: np.ndarray,
                     device=None) -> None:
    """Phase 4's checks of the API that takes no kernel of its own:
    ``stft`` and ``spectrogram`` (power 1 and 2) on the 16 s batch on the
    card against the same call on the CPU (1e-5 of max|Z|);
    ``SpeechBERTScore(checkpoint=...)`` from a ``save_params`` file of the
    seeded full-width weights (a temporary directory, deleted after),
    through ``__call__``: A7 and A8 launched as often as by ``sbs`` (the
    ``params=`` route, whose F1 is ``f1``) and its F1 bit-equal to ``f1``."""
    import tempfile
    from functools import partial

    from fast_speech_enhancement_metrics_tpu_torch.ops import attn_block_pallas, cuda_lib, stft
    from fast_speech_enhancement_metrics_tpu_torch.utils.convert_hubert import save_params

    phase("main path: stft, the checkpoint route")
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    x_cpu = torch.from_numpy(clean_np)
    x = x_cpu.to(dev)
    for kw in (dict(n_fft=512, hop=256, center=True), dict(n_fft=512, hop=160, win_length=400)):
        for what, fn in (("stft", stft.stft), ("spectrogram power=1", partial(stft.spectrogram, power=1.0)),
                         ("spectrogram power=2", partial(stft.spectrogram, power=2.0))):
            got, want = fn(x, **kw), fn(x_cpu, **kw)
            check(got.device.type == dev.type, f"{what} {kw}: the result left the input's device")
            got = got.cpu()
            finite = torch.isfinite(torch.view_as_real(got) if got.is_complex() else got)
            check(got.shape == want.shape and got.dtype == want.dtype and bool(torch.all(finite)),
                  f"{what} {kw}: {tuple(got.shape)} {got.dtype} on the card, {tuple(want.shape)} {want.dtype} on "
                  "the CPU, or not finite")
            gap, scale = float((got - want).abs().max()), float(want.abs().max())
            check(gap <= 1e-5 * scale, f"{what} {kw}: card vs CPU {gap:.3e} over 1e-5 of max {scale:.3e}")
            log(f"{what} {kw} on {tuple(got.shape)}: card vs CPU max gap {gap:.3e} (limit 1e-5 x {scale:.4g})")
    del x, x_cpu

    kernels = (attn_block_pallas.KERNEL_A7, attn_block_pallas.KERNEL_A8)
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mhubert147.npz"
        save_params(sbs_params, str(path))
        size_mb = path.stat().st_size / 1e6
        from_file = pkg.SpeechBERTScore(checkpoint=path, device=device)
    for metric in (sbs, from_file):
        torch.cuda.synchronize()
        cuda_lib.launch_counts.clear()
        rows = metric(clean_np, noisy_np)
        torch.cuda.synchronize()
        counts.append({k: cuda_lib.launch_counts.get(k, 0) for k in kernels})
    f1_file = np.array([r["SpeechBERTScore"] for r in rows])
    check(counts[1] == counts[0] and (dev.type != "cuda" or all(counts[1].values())),
          f"SpeechBERTScore(checkpoint=...) launched {counts[1]}, params= {counts[0]}")
    check(f1_file.shape == f1.shape and np.array_equal(f1_file, f1),
          f"SpeechBERTScore(checkpoint=...) vs params=: max diff {float(np.max(np.abs(f1_file - f1))):.3e}")
    log(f"SpeechBERTScore(checkpoint=<{size_mb:.0f} MB npz>): launches {counts[1]} (as params=), F1 bit-equal to "
        f"the params= route on {len(f1)} rows")
    del from_file


def fe_inputs(dev: torch.device) -> tuple[torch.Tensor, list, list]:
    """FE's operands at the main path's shape: a GELU output of conv 0's
    shape on 64 rows of 16 s (512 x 51 199), He-scaled weights of convs
    1-6 and their bf16 pieces; the same from every call."""
    from fast_speech_enhancement_metrics_tpu_torch.models import hubert
    from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu

    cfg = hubert.MHUBERT_147_CONFIG
    g = torch.Generator(device=dev).manual_seed(16)
    t_in = (SECONDS * RATE - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    x = torch.nn.functional.gelu(torch.randn(BATCH, cfg.conv_dim[0], t_in, device=dev, generator=g))
    ws = [torch.randn(c_out, c_in, k, device=dev, generator=g) * (c_in * k) ** -0.5
          for c_in, c_out, k in zip(cfg.conv_dim, cfg.conv_dim[1:], cfg.conv_kernel[1:])]
    return x, ws, [conv_gelu.split_pieces(w) for w in ws]


def conv0_times(sbs, smi: str, clean: torch.Tensor) -> None:
    """Phase 5, for the record: conv 0 and the whole feature encoder of the
    ``sbs`` encoder on ``clean``."""
    from fast_speech_enhancement_metrics_tpu_torch.models import hubert

    enc = sbs.encoder
    w, stride = enc.feature_encoder[0]["w"], enc.config.conv_stride[0]
    x = clean[:, None]

    def conv0():
        with hubert._conv_flags():
            return torch.nn.functional.conv1d(x, w, stride=stride)

    from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, cuda_lib

    with torch.inference_mode():
        before = cuda_lib.launch_counts[conv_gelu.KERNEL]
        hubert.feature_encoder(enc, clean)
        launches = cuda_lib.launch_counts[conv_gelu.KERNEL] - before
        log(json.dumps({"what": "HuBERT feature encoder", "rows": clean.shape[0], "seconds": clean.shape[1] / RATE,
                        "card": smi, "conv0_ms": cuda_ms(conv0), "conv_gelu_launches": launches,
                        "feature_encoder_ms": cuda_ms(lambda: hubert.feature_encoder(enc, clean))}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import fast_speech_enhancement_metrics_tpu_torch as pkg
    from fast_speech_enhancement_metrics_tpu_torch.models import dnsmos_net, hubert
    from fast_speech_enhancement_metrics_tpu_torch.ops import (
        attn_block_pallas,
        conv_gelu,
        cuda_lib,
        levinson_pallas,
        lsd_fused,
        sdpa_pallas,
        sdr_corr_fused,
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
    sm_clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]) * 1e6
    log(f"maximum SM clock {sm_clock_hz / 1e6:.0f} MHz")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls would use TF32")
    with hubert._conv_flags():  # as the HuBERT encoder sets it around every conv
        conv_tf32 = torch.backends.cudnn.allow_tf32
    log(f"torch.backends.cudnn.allow_tf32 inside the metrics' convs={conv_tf32}")
    check(not conv_tf32, "the metrics' float32 convs would use TF32")
    with dnsmos_net._conv_flags():  # as the DNSMOS net sets it around its trunk
        dnsmos_tf32 = torch.backends.cudnn.allow_tf32
    log(f"torch.backends.cudnn.allow_tf32 inside DNSMOS's convs={dnsmos_tf32}")
    check(not dnsmos_tf32, "DNSMOS's float32 convs would use TF32")

    # -- 2. build -------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    so = cuda_lib.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for src in cuda_lib.SOURCES:
        text = (cuda_lib.BUILD_DIR / f"{src.rsplit('.', 1)[0]}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if any(key in line for key in ("entry function", "registers", "spill", "C75")):
                    log(f"  ptxas {src}: {line.strip()}")

    # the Hopper kernels must run on wgmma and TMA: count the warpgroup
    # products (HGMMA in bf16, IGMMA in int8) and tensor loads (UTMALDG) in
    # the SASS of every instantiation, and the spills ptxas reports for each:
    # the attention kernel (A9, A15, A7: 2 head-width classes x 4 softmax
    # modes, all in sdpa.cu) and its float32 arm (sdpa_f32.cu, the same
    # classes and modes), the GEMM (A7, A8: 3 bf16 epilogues in
    # attn_block.cu; A12: its int8 arm, gemm_kernel<3>, in attn_block_int8.cu)
    # and A12's int8 attention (4 head-width classes x 3 modes); SDR's
    # correlations: A4's Gram (splits x4, x3, x1) and A10's chunk DFT;
    # LSD's frame-tile kernel (A1, A2, A3)
    cuobjdump = shutil.which("cuobjdump") or str(Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    int8_gemm = "gemm_kernelILi3E"
    for kernel, source, n, product, keep in (
        ("flash_kernel", "sdpa", 8, "HGMMA", lambda name: True),
        ("flash_f32_kernel", "sdpa_f32", 8, "HGMMA", lambda name: True),
        ("gemm_kernel", "attn_block", 3, "HGMMA", lambda name: int8_gemm not in name),
        ("gemm_kernel", "attn_block_int8", 1, "IGMMA", lambda name: int8_gemm in name),
        ("i8_attention_kernel", "attn_block_int8", 12, "IGMMA", lambda name: True),
        ("gram_kernel", "sdr_corr_gram", 3, "HGMMA", lambda name: True),
        ("corr_dft_kernel", "sdr_corr_fused", 1, "HGMMA", lambda name: True),
        ("lsd_tile_kernel", "lsd_fused", 1, "HGMMA", lambda name: True),
        ("conv_gelu_kernel", "conv_gelu", 4, "HGMMA", lambda name: True),
    ):
        funcs = [f for f in sass.split("Function : ")[1:]
                 if kernel in f.split("\n", 1)[0] and keep(f.split("\n", 1)[0])]
        counts = [(f.count(product), f.count("UTMALDG")) for f in funcs]
        log(f"SASS: {len(funcs)} {kernel} instantiations of {source}.cu; {product} and UTMALDG in each: {counts}")
        check(len(funcs) == n and all(h > 0 and t > 0 for h, t in counts),
              f"{kernel} ({source}.cu): not {n} instantiations, each built on {product} and TMA")
        # ... and spill nothing: ptxas's spill line follows each entry function
        spills, entry = [], ""
        for line in (cuda_lib.BUILD_DIR / f"{source}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "spill stores" in line and kernel in entry and keep(entry):
                spills.append(sum(int(k) for k in re.findall(r"(\d+) bytes spill", line)))
        log(f"ptxas: {kernel} ({source}.cu) spill bytes (stores + loads) per instantiation: {spills}")
        check(len(spills) == n and not any(spills), f"{kernel} ({source}.cu) spills registers")

    # the Levinson warp kernels (A5, and A14's flat x 3 unrollings,
    # dotreduce and double: one instantiation per order 32 .. 1024) and A6's
    # segment kernel keep their state in registers: no spills either
    for kernel, source, n in (("levinson_warp_kernel", "levinson", 32), ("levinson_flat_warp_kernel", "levinson_flat", 96),
                              ("levinson_dotreduce_warp_kernel", "levinson_dotreduce", 32),
                              ("levinson_double_warp_kernel", "levinson_double", 32),
                              ("stoi_segments_kernel", "stoi_fused", 1)):
        spills, entry = [], ""
        for line in (cuda_lib.BUILD_DIR / f"{source}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "spill stores" in line and kernel in entry:
                spills.append(sum(int(k) for k in re.findall(r"(\d+) bytes spill", line)))
        log(f"ptxas: {kernel} ({source}.cu) spill bytes (stores + loads) per instantiation: {spills}")
        check(len(spills) == n and not any(spills), f"{kernel} ({source}.cu) spills registers")

    # -- 3. kernels against their plain versions --------------------------------
    phase("kernels against their plain versions")
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
            "replaces": f"{JAX_PACKAGE}/{replaces if replaces.startswith('models/') else 'ops/' + replaces}",
            "max_abs_err": err, "tolerance": tol,
        }

    # A1: LSD scores, atol 2e-4 (the metric's contract without its rtol
    # part), on the speech pairs and on a near-clean pair (speech + 1e-3
    # max|speech| Gaussian noise: log ratios near 0, where the chunk DFT's
    # precision class shows); two launches bit-equal; the distance of the
    # kernel (bf16x6 chunk DFT) and of the plain version (float32) from a
    # float64 reference printed
    def near_clean(x, seed=0):
        g = torch.Generator().manual_seed(seed)
        return (x + 1e-3 * x.abs().max() * torch.randn(x.shape, generator=g).to(x.device)).contiguous()

    def lsd_f64(cx, dx):
        """LSD of pre-scaled pairs in float64: framed rfft of the centered,
        Hann-windowed frames."""
        cx, dx = cx.double(), dx.double()
        t_n = cx.shape[1]
        f_n = 1 + t_n // HOP
        win = torch.hann_window(2 * HOP, periodic=True, dtype=torch.float64, device=cx.device)

        def power(x):
            xp = torch.nn.functional.pad(x, (HOP, (f_n + 1) * HOP - t_n - HOP))
            return torch.fft.rfft(xp.unfold(-1, 2 * HOP, HOP)[:, :f_n] * win, dim=-1).abs() ** 2

        dm = torch.sqrt(power(dx)) + EPS
        lr = torch.log(power(cx) / (dm * dm) + EPS)
        return torch.sqrt(torch.mean(lr * lr, dim=-1)).mean(dim=-1)

    def lsd_check(kid, wrapper, plain, cx, dx, scaled_dx, what, kind="bf16x6", f64_tol=None):
        """wrapper vs plain at atol 2e-4, twice bit-equal; both against
        float64 (on the pre-scaled pair), the kernel within ``f64_tol`` of
        it where one is given; returns the kernel's error and scores."""
        got = wrapper(cx, dx, HOP, EPS)
        check(torch.equal(got, wrapper(cx, dx, HOP, EPS)), f"{kid}: two launches differ ({what})")
        err_ = torch.max(torch.abs(got - plain(cx, dx, HOP, EPS))).item()
        check(math.isfinite(err_) and err_ <= 2e-4, f"{kid}: {err_:.3e} from its plain version ({what}; atol 2e-4)")
        ref = lsd_f64(cx, scaled_dx)
        f64 = torch.max(torch.abs(got.double() - ref)).item()
        log(f"{kid} {what}: vs plain {err_:.3e}; vs float64: kernel ({kind}) {f64:.3e}, plain (float32) "
            f"{torch.max(torch.abs(plain(cx, dx, HOP, EPS).double() - ref)).item():.3e}; two launches bit-equal")
        if f64_tol is not None:
            check(f64 <= f64_tol, f"{kid}: {f64:.3e} from a float64 LSD ({what}; atol {f64_tol})")
        return err_, got

    def prescaled(cx, dx):
        return dx * (torch.sum(cx * dx, dim=1, keepdim=True) / (torch.sum(dx * dx, dim=1, keepdim=True) + EPS))

    raw_a1 = (lsd_fused.lsd_wholesig_raw, lsd_fused._lsd_wholesig_raw_plain)
    err, lsd_k = lsd_check("A1", *raw_a1, c, d, prescaled(c, d), "speech pairs")
    err_near, a1_near = 0.0, []
    for seed in range(3):  # A1's near-clean pairs from three noise seeds
        d_near = near_clean(c, seed)
        e_, got_ = lsd_check("A1", *raw_a1, c, d_near, prescaled(c, d_near), f"near-clean pairs, seed {seed}")
        err_near = max(err_near, e_)
        a1_near.append(got_)
    record("A1", lsd_fused.KERNEL, "lsd_fused.cu", "lsd_fused.py:208", max(err, err_near), 2e-4,
           f"; speech pairs {err:.3e}, near-clean pairs {err_near:.3e}")

    # A13: the factorized chunk DFT as a float32 FFT, against its plain
    # version and A1, atol 2e-4, twice bit-equal; on A1's near-clean pairs
    # also within 2e-4 of a float64 LSD, each distance printed
    ct_a13 = (lsd_fused.lsd_wholesig_ct, lsd_fused._lsd_wholesig_ct_plain)
    err, ct_k = lsd_check("A13", *ct_a13, c, d, prescaled(c, d), "speech pairs", "float32 FFT", 2e-4)
    err_a1 = torch.max(torch.abs(ct_k - lsd_k)).item()
    err_near = 0.0
    for seed in range(3):
        d_near = near_clean(c, seed)
        e_, got_ = lsd_check("A13", *ct_a13, c, d_near, prescaled(c, d_near), f"near-clean pairs, seed {seed}",
                             "float32 FFT", 2e-4)
        err_near = max(err_near, e_)
        err_a1 = max(err_a1, torch.max(torch.abs(got_ - a1_near[seed])).item())
    check(err_a1 <= 2e-4, f"A13 differs from A1 by {err_a1:.3e} (tolerance 2e-4)")
    record("A13", lsd_fused.KERNEL_A13, "lsd_fused.cu", "lsd_fused.py:537", max(err, err_near), 2e-4,
           f"; speech pairs {err:.3e}, near-clean pairs {err_near:.3e}; against A1 {err_a1:.3e} (tolerance 2e-4)")

    # A4: correlations of the raw signals, atol 2e-4 * max|r_auto|
    ra_k, rc_k = sdr_corr_gram.correlation_lags_gram(c, d, LAGS)
    ra_p, rc_p = sdr_corr_gram._correlation_lags_plain(c, d, LAGS)
    scale = torch.max(torch.abs(ra_p)).item()
    err = max(torch.max(torch.abs(ra_k - ra_p)).item(), torch.max(torch.abs(rc_k - rc_p)).item())
    record("A4", sdr_corr_gram.KERNEL, "sdr_corr_gram.cu", "sdr_corr_gram.py:57", err, 2e-4 * scale,
           f"; the four-term bf16 class against the float32 correlation: {err / scale:.3e} of max|r_auto|")
    # the split pass that A4 and A10 run first, bit for bit against its
    # plain version, also with a zero-padded tail
    for row_len in (-(-t_len // 128) * 128, -(-t_len // LAGS) * LAGS + LAGS):
        got_h = sdr_corr_gram.split_halves(c, d, row_len)
        check(torch.equal(got_h.view(torch.int16),
                          sdr_corr_gram._split_halves_plain(c, d, row_len).view(torch.int16)),
              f"the split pass differs from its plain version at row length {row_len}")
    log("split pass (A4, A10): bit-equal to its plain version")
    # A4 in the JAX kernel's reduced product classes (split x3: bf16 halves
    # hh + hl + lh; x1: hh), against the plain correlation summed over the
    # halves, atol 2e-4 * max|r_auto|
    for split in ("x3", "x1"):
        ra_s, rc_s = sdr_corr_gram.correlation_lags_gram(c, d, LAGS, split)
        pa_s, pc_s = sdr_corr_gram._correlation_lags_plain(c, d, LAGS, split)
        err = max(torch.max(torch.abs(ra_s - pa_s)).item(), torch.max(torch.abs(rc_s - pc_s)).item())
        record(f"A4-{split}", sdr_corr_gram.KERNELS[split], "sdr_corr_gram.cu", "sdr_corr_gram.py:57", err,
               2e-4 * torch.max(torch.abs(pa_s)).item(), f" (split {split})")

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
    # ... two launches bit-equal, and bit for bit its warp-order reference
    check(torch.equal(x_k, levinson_pallas.levinson_solve_fused(r0n, bn)), "A5: two launches differ")
    check(torch.equal(x_k, levinson_pallas._levinson_warp_order_reference(r0n, bn)),
          "A5 differs from its warp-order reference")
    # ... and at the largest order it takes, 1024, on a few rows of decaying
    # (cond ~60) systems, at 2e-3 of max|x|
    rs_l = np.random.RandomState(17)
    r_big = (0.9 ** np.arange(1024))[None] * rs_l.uniform(0.5, 20.0, (4, 1))
    r_big[:, 0] += 1.0
    r_big = torch.tensor(r_big, dtype=torch.float32, device=dev)
    b_big = torch.tensor(rs_l.randn(4, 1024), dtype=torch.float32, device=dev)
    x_big = levinson_pallas.levinson_solve_fused(r_big, b_big)
    want_big = toeplitz.levinson_solve(r_big, b_big)
    rel_big = (torch.max(torch.abs(x_big - want_big)) / torch.max(torch.abs(want_big))).item()
    check(math.isfinite(rel_big) and rel_big <= 2e-3, f"A5 at n = 1024: {rel_big:.2e} of max|x| (tolerance 2e-3)")
    record("A5", levinson_pallas.KERNEL, "levinson.cu", "levinson_pallas.py:38", err, 1e-2,
           f" dB of SDR; solution max diff {rel_x:.2e} of max|x| (tolerance 2e-3); two launches and its warp-order "
           f"reference bit-equal; at n = 1024 on 4 rows {rel_big:.2e} of max|x| (tolerance 2e-3)")

    # A14: the other Levinson variants on the same systems, each against its
    # plain version at 2e-3 of max|x|, and the SDR each gives against A5's
    # at 1e-2 dB; each bit for bit its torch twin (dotreduce: A5's order,
    # so also A5's bits) and twice bit-equal
    a14_ids = {"double": "A14", "flat": "A14-flat", "flat_u4": "A14-flat_u4", "flat_u8": "A14-flat_u8",
               "dotreduce": "A14-dotreduce"}
    a14_lines = {"double": "levinson_pallas.py:157", "dotreduce": "levinson_pallas.py:251"}
    for variant, kid in a14_ids.items():
        xv_k = levinson_pallas.levinson_solve_fused(r0n, bn, variant=variant)
        xv_p = levinson_pallas._plain(variant)(r0n, bn)
        rel_v = (torch.max(torch.abs(xv_k - xv_p)) / torch.max(torch.abs(xv_p))).item()
        sdr_vs_a5 = torch.max(torch.abs(sdr_db(bn, xv_k) - sdr_db(bn, x_k))).item()
        check(math.isfinite(sdr_vs_a5) and sdr_vs_a5 <= 1e-2,
              f"{kid}: SDR {sdr_vs_a5:.2e} dB from A5's (tolerance 1e-2)")
        check(torch.equal(xv_k, levinson_pallas.levinson_solve_fused(r0n, bn, variant=variant)),
              f"{kid}: two launches differ")
        check(torch.equal(xv_k, levinson_pallas._warp_twin(variant)(r0n, bn)), f"{kid} differs from its torch twin")
        if variant == "dotreduce":
            check(torch.equal(xv_k, x_k), f"{kid} is not A5 bit for bit")
        record(kid, levinson_pallas.KERNELS[variant], "levinson.cu", a14_lines.get(variant, "levinson_pallas.py:110"),
               rel_v, 2e-3, f" of max|x| (variant {variant}); its SDR {sdr_vs_a5:.2e} dB from A5's (tolerance 1e-2); "
               "two launches and its torch twin bit-equal")

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
    s_k2, e_k2 = stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg)
    check(torch.equal(s_k, s_k2) and torch.equal(e_k, e_k2), "A6: two launches differ")
    # ... and on the same envelopes with ragged segment counts: rows of 0,
    # ending mid-tile (at most 469: tiles of 64 segments), their own full
    # count, and 3 (past a row's count its envelopes are the silent-frame
    # padding, whose segments no count reaches)
    pick = torch.arange(BATCH, device=dev) % 4
    ragged = torch.where(pick == 0, 0, torch.where(pick == 1, torch.clamp(nseg, max=64 * 7 + 21),
                                                   torch.where(pick == 2, nseg, torch.clamp(nseg, max=3))))
    ragged = ragged.to(torch.int32).contiguous()
    s_r, e_r = stoi_fused.stoi_segment_sums(tob_c, tob_d, ragged)
    ps_r, pe_r = stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, ragged, 30, 15)
    per_r = torch.clamp(ragged, min=1).float()
    err_r = max(torch.max(torch.abs(s_r - ps_r) / 15 / per_r).item(),
                torch.max(torch.abs(e_r - pe_r) / 30 / per_r).item())
    check(s_r[0].item() == 0.0 and e_r[0].item() == 0.0, "A6: a row of no segments does not sum to 0")
    record("A6", stoi_fused.KERNEL, "stoi_fused.cu", "stoi_fused.py:59", max(err, err_r), 5e-4,
           f"; main path's segment counts {err:.3e}, ragged counts (0, mid-tile, full, 3) {err_r:.3e}; "
           f"two launches bit-equal")

    # A2, A3: LSD of pre-scaled pairs that are not hop-aligned, atol 2e-4;
    # the 16 s + 100 batch is the first A2_SAMPLES of the 20 s + 100 one
    long_c_np, long_d_np, _ = load_audio_data(A3_SAMPLES / RATE + 0.01, BATCH, RATE)
    unaligned = {}
    for kid, n, wrapper, plain, kname, line in (
        ("A2", A2_SAMPLES, lsd_fused.lsd_wholesig, lsd_fused._lsd_wholesig_plain,
         lsd_fused.KERNEL_A2, "lsd_fused.py:141"),
        ("A3", A3_SAMPLES, lsd_fused.lsd_framed, lsd_fused._lsd_framed_plain,
         lsd_fused.KERNEL_A3, "lsd_fused.py:619"),
    ):
        c_np, d_np = np.ascontiguousarray(long_c_np[:, :n]), np.ascontiguousarray(long_d_np[:, :n])
        cu, du = torch.from_numpy(c_np).to(dev), torch.from_numpy(d_np).to(dev)
        ds = prescaled(cu, du).contiguous()
        unaligned[kid] = (c_np, d_np, cu, ds)
        err, _ = lsd_check(kid, wrapper, plain, cu, ds, ds, f"{n} samples, speech pairs")
        ds_near = prescaled(cu, near_clean(cu)).contiguous()
        err_near, _ = lsd_check(kid, wrapper, plain, cu, ds_near, ds_near, f"{n} samples, near-clean pairs")
        record(kid, kname, "lsd_fused.cu", line, max(err, err_near), 2e-4,
               f" ({n} samples; speech pairs {err:.3e}, near-clean pairs {err_near:.3e})")

    # A7, A8: one mHuBERT-147 layer at full width on a (64, 799, 768) input;
    # q_w and k_w drawn large enough that the softmax is far from flat
    cfg = hubert.MHUBERT_147_CONFIG
    d_model, heads, ffn = cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size
    blk_frames = t_len
    for k_, s_ in zip(cfg.conv_kernel, cfg.conv_stride):
        blk_frames = (blk_frames - k_) // s_ + 1
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale, g=gen):
        return torch.randn(*shape, generator=g, device=dev) * scale

    layer = {name: rnd(d_model, d_model, scale=0.06 if name in ("q_w", "k_w") else 0.02)
             for name in ("q_w", "k_w", "v_w", "o_w")}
    layer.update({name: rnd(d_model, scale=0.02) for name in ("q_b", "k_b", "v_b", "o_b", "ff_b2")})
    layer.update(ff_w1=rnd(d_model, ffn, scale=0.02), ff_b1=rnd(ffn, scale=0.02),
                 ff_w2=rnd(ffn, d_model, scale=0.02),
                 ln1_s=1 + rnd(d_model, scale=0.1), ln1_b=rnd(d_model, scale=0.1),
                 ln2_s=1 + rnd(d_model, scale=0.1), ln2_b=rnd(d_model, scale=0.1))
    x_blk = rnd(BATCH, blk_frames, d_model, scale=1.0)
    packed = {mode: attn_block_pallas.pack_attn_block_params(layer, heads, mode)
              for mode in attn_block_pallas.SOFTMAX_MODES}
    wqkv, bqkv = packed["exp2"][:2]
    qk = (x_blk[0].to(torch.bfloat16).float() @ wqkv.float() + bqkv)[:, :2 * d_model]
    q_, k_ = (qk[:, i * d_model:(i + 1) * d_model].reshape(blk_frames, heads, -1).transpose(0, 1) for i in (0, 1))
    log(f"A7 input: max|s * log2 e| over row 0 = {torch.max(torch.abs(q_ @ k_.transpose(1, 2))).item():.2f} "
        f"({blk_frames} frames, {heads} heads)")
    blk_tol, blk_med_tol = 3e-2, 1e-3  # the JAX block tests' bf16 class

    def block_err(got, want, what):
        diff = torch.abs(got.float() - want.float())
        mx, med = torch.max(diff).item(), torch.median(diff).item()
        log(f"  {what}: max abs {mx:.3e}, median abs {med:.3e}")
        check(med <= blk_med_tol, f"{what}: median abs error {med:.3e} over {blk_med_tol}")
        return mx

    err = max(
        block_err(attn_block_pallas.attn_block(x_blk, packed[mode], heads, cfg.layer_norm_eps, mode),
                  attn_block_pallas._attn_block_plain(x_blk, packed[mode], heads, cfg.layer_norm_eps, mode),
                  f"A7 softmax={mode}")
        for mode in attn_block_pallas.SOFTMAX_MODES
    )
    # A7 at other head widths, 8 x 799: heads of 32 (768 / 24), 80
    # (HuBERT-xlarge's 1280 / 16), 96 (768 / 8) and 12 (768 / 64, not a
    # multiple of 8: through zero-padded copies of q, k, v and the context)
    for d_w, h_w in ((768, 24), (1280, 16), (768, 8), (768, 64)):
        lw = {name: rnd(d_w, d_w, scale=0.06 if name in ("q_w", "k_w") else 0.02)
              for name in ("q_w", "k_w", "v_w", "o_w")}
        lw.update({name: rnd(d_w, scale=0.02) for name in ("q_b", "k_b", "v_b", "o_b")})
        lw.update(ln1_s=1 + rnd(d_w, scale=0.1), ln1_b=rnd(d_w, scale=0.1))
        xw = rnd(8, blk_frames, d_w, scale=1.0)
        for mode in attn_block_pallas.SOFTMAX_MODES:
            pw = attn_block_pallas.pack_attn_block_params(lw, h_w, mode)
            err = max(err, block_err(attn_block_pallas.attn_block(xw, pw, h_w, cfg.layer_norm_eps, mode),
                                     attn_block_pallas._attn_block_plain(xw, pw, h_w, cfg.layer_norm_eps, mode),
                                     f"A7 heads of {d_w // h_w} softmax={mode}"))
        del xw, lw
    record("A7", attn_block_pallas.KERNEL_A7, "attn_block.cu", "attn_block_pallas.py:64", err, blk_tol)
    ffn_packed = attn_block_pallas.pack_ffn_block_params(layer)
    err = block_err(attn_block_pallas.ffn_block(x_blk, ffn_packed, cfg.layer_norm_eps),
                    attn_block_pallas._ffn_block_plain(x_blk, ffn_packed, cfg.layer_norm_eps, "tanh"),
                    "A8 gelu=tanh")
    record("A8", attn_block_pallas.KERNEL_A8, "attn_block.cu", "attn_block_pallas.py:213", err, blk_tol)

    # A11: the whole layer, every softmax mode: A7's and A8's launches
    # chained, LN1 written once in bf16 (which A8 rounds its input to
    # anyway), so bit-equal to A7 then A8. Against the plain version of the
    # whole layer the two stages' roundings compound: a sub-ulp difference in
    # the intermediate h can flip bf16(h) at the FFN stage's entry, one bf16
    # ulp (0.031 for |h| in [4, 8)) carried through LN2, so the chain is held
    # at the class of two stages, max 2 x 3e-2, median 1e-3
    err = 0.0
    for mode in attn_block_pallas.SOFTMAX_MODES:
        got = attn_block_pallas.layer_block(x_blk, packed[mode], ffn_packed, heads, cfg.layer_norm_eps, mode)
        h_k = attn_block_pallas.attn_block(x_blk, packed[mode], heads, cfg.layer_norm_eps, mode)
        chained = attn_block_pallas.ffn_block(h_k, ffn_packed, cfg.layer_norm_eps)
        vs_a7_a8 = torch.max(torch.abs(got - chained)).item()
        log(f"  A11 softmax={mode} against A7 then A8: max abs {vs_a7_a8:.3e} (bit-equal: {torch.equal(got, chained)})")
        check(torch.equal(got, chained), f"A11 softmax={mode} is not A7 then A8 bit for bit")
        err = max(err, block_err(got, attn_block_pallas._layer_block_plain(
            x_blk, packed[mode], ffn_packed, heads, cfg.layer_norm_eps, mode, "tanh"), f"A11 softmax={mode}"))
        del got, h_k, chained
    record("A11", attn_block_pallas.KERNEL_A11, "layer_block.cu", "attn_block_pallas.py:298", err, 2 * blk_tol,
           " (the whole layer against its plain version, at twice the bf16 class; bit-equal to A7 then A8)")

    # A12: the int8 block, every softmax mode, against its plain version in
    # the bf16 class and against A7 in the JAX package's int8 screening
    # class (median < 0.05, max < 0.5; tests/test_speechbertscore.py)
    packed_i8 = {mode: attn_block_pallas.pack_attn_block_params(layer, heads, mode, quant="int8")
                 for mode in attn_block_pallas.SOFTMAX_MODES}
    err = 0.0
    for mode in attn_block_pallas.SOFTMAX_MODES:
        got = attn_block_pallas.attn_block(x_blk, packed_i8[mode], heads, cfg.layer_norm_eps, mode, quant="int8")
        err = max(err, block_err(got, attn_block_pallas._attn_block_int8_plain(
            x_blk, packed_i8[mode], heads, cfg.layer_norm_eps, mode), f"A12 softmax={mode}"))
        vs_a7 = torch.abs(got - attn_block_pallas.attn_block(x_blk, packed[mode], heads, cfg.layer_norm_eps, mode))
        a7_max, a7_med = torch.max(vs_a7).item(), torch.median(vs_a7).item()
        log(f"  A12 softmax={mode} against A7: max abs {a7_max:.3e} (limit 0.5), median abs {a7_med:.3e} (limit 0.05)")
        check(a7_max < 0.5 and a7_med < 0.05, f"A12 softmax={mode} outside the int8 screening class against A7")
        del got, vs_a7
    record("A12", attn_block_pallas.KERNEL_A12, "attn_block_int8.cu", "attn_block_pallas.py:40", err, blk_tol,
           " (the int8 arm of _attn_block_kernel: _quant_rows :40, _quant_cols :47, _dot_i8 :55)")
    # A12's int8 GEMM alone at the layer's QKV and W_o products, on the
    # quantized x and the int8 weights, exactly against its plain version
    # (the integer products are exact, the dequantization the same fp32 steps)
    xq_i8, sx_i8 = attn_block_pallas._quant_rows(x_blk.reshape(-1, d_model).to(torch.bfloat16).float())
    xq_i8, sx_i8 = xq_i8.to(torch.int8), sx_i8.reshape(-1).contiguous()
    gemm_i8_args = {"QKV": (xq_i8, packed_i8["exp2"][0], sx_i8, packed_i8["exp2"][1][1].contiguous(),
                            packed_i8["exp2"][1][0].contiguous()),
                    "W_o": (xq_i8, packed_i8["exp2"][2], sx_i8, packed_i8["exp2"][3][1].contiguous(),
                            packed_i8["exp2"][3][0].contiguous())}
    for name, args in gemm_i8_args.items():
        got, want = attn_block_pallas.gemm_i8(*args), attn_block_pallas._gemm_i8_plain(*args)
        diff = torch.max(torch.abs(got - want)).item()
        log(f"  A12 int8 GEMM {name} ({args[0].shape[0]} x {args[1].shape[0]} x {args[0].shape[1]}): max abs "
            f"{diff:.3e} from its plain version (bit-equal: {torch.equal(got, want)})")
        check(torch.equal(got, want), f"A12 int8 GEMM {name} is not its plain version bit for bit")
        del got, want

    # A9 at the 16 x 60 s path's shape (16 rows x 12 heads x 2999 frames x
    # 64): the three softmax modes in bf16 and "exact" in float32 (atol
    # 1e-4: float32 sums over 2999 keys in another order); then heads of 80
    # (HuBERT-xlarge: 16 heads) at 4 x 1499. An attention context is a
    # weighted mean of v: most query rows are far below the ~1 of A7's
    # LayerNorm output, a few that fix on one key are near max|v|. So in
    # bf16 the block class holds per query row, each error over its row's
    # max|want|: max 3e-2, median 1e-3. A9 and A15 draw from generators of
    # their own (tools/attention_row_witness.py replays A9's): their inputs
    # do not depend on the checks before them
    long_frames = LONG_SECONDS * RATE // 320 - 1  # 2999, as the conv stack gives
    f32_tol = 1e-4
    gen_a9 = torch.Generator(device=dev).manual_seed(A9_SEED)
    gen_a15 = torch.Generator(device=dev).manual_seed(A15_SEED)

    def qkv(shape, dtype, g):
        return [rnd(*shape, scale=1.2, g=g).to(dtype) for _ in range(3)]

    def f32_err(got, want, what):
        mx = torch.max(torch.abs(got - want)).item()
        log(f"  {what}: max abs {mx:.3e} (tolerance {f32_tol})")
        check(math.isfinite(mx) and mx <= f32_tol, f"{what}: max abs error {mx:.3e} over {f32_tol}")
        return mx

    # the float32 arms (bf16x6) and their plain versions (float32) on the
    # first 128 queries against a float64 softmax of the same inputs: the
    # kernel within 1e-5 of it
    f64_tol = 1e-5

    def f64_err(got, want, q_, k_, v_, scaling, what):
        sl = slice(0, 128)
        s64 = torch.matmul(q_[:, :, sl].double(), k_.double().transpose(-1, -2)) * scaling
        ref = torch.matmul(torch.softmax(s64, dim=-1), v_.double())
        del s64
        mx = torch.max(torch.abs(got[:, :, sl].double() - ref)).item()
        plain_mx = torch.max(torch.abs(want[:, :, sl].double() - ref)).item()
        log(f"  {what}, queries 0-127 against float64: kernel {mx:.3e} (tolerance {f64_tol}), plain version "
            f"{plain_mx:.3e}")
        check(math.isfinite(mx) and mx <= f64_tol, f"{what}: {mx:.3e} from a float64 softmax (tolerance {f64_tol})")
        return mx

    def context_err(got, want, what, worst):
        """Check one bf16 context against the per-row class; return the
        worse of ``worst`` and this case as (error / row max|want|, max abs
        error, the limit at that element)."""
        diff = torch.abs(got.float() - want.float())
        row = torch.amax(torch.abs(want.float()), dim=-1, keepdim=True).expand_as(diff)
        rel = diff / row
        rmax, rmed = torch.max(rel).item(), torch.median(rel).item()
        at = torch.argmax(diff)
        mx, limit = diff.flatten()[at].item(), blk_tol * row.flatten()[at].item()
        log(f"  {what}: max abs {mx:.3e} (limit there {limit:.3e}); error / the row's max|want|: max "
            f"{rmax:.3e} (limit {blk_tol}), median {rmed:.3e} (limit {blk_med_tol}); row max|want| "
            f"{torch.min(row).item():.3e} to {torch.max(row).item():.3e}")
        check(math.isfinite(rmax) and rmax <= blk_tol and rmed <= blk_med_tol,
              f"{what}: beyond the per-row bf16 class")
        return max(worst, (rmax, mx, limit))

    worst, worst_f32, worst_f64 = (0.0, 0.0, 1.0), 0.0, 0.0
    for b_, h_, t_, d_ in ((LONG_BATCH, heads, long_frames, 64), (4, 16, 1499, 80)):
        q9, k9, v9 = qkv((b_, h_, t_, d_), torch.bfloat16, gen_a9)
        for mode in sdpa_pallas.SOFTMAX_MODES:
            worst = context_err(sdpa_pallas.sdpa(q9, k9, v9, d_**-0.5, softmax=mode),
                                sdpa_pallas._sdpa_plain(q9, k9, v9, d_**-0.5, mode),
                                f"A9 {b_}x{h_}x{t_}x{d_} bf16 softmax={mode}", worst)
        q9, k9, v9 = (a.float() for a in (q9, k9, v9))
        got_f32 = sdpa_pallas.sdpa(q9, k9, v9, d_**-0.5, softmax="exact")
        want_f32 = sdpa_pallas._sdpa_plain(q9, k9, v9, d_**-0.5, "exact")
        what = f"A9 {b_}x{h_}x{t_}x{d_} float32 softmax=exact"
        worst_f32 = max(worst_f32, f32_err(got_f32, want_f32, what))
        worst_f64 = max(worst_f64, f64_err(got_f32, want_f32, q9, k9, v9, d_**-0.5, what))
        del got_f32, want_f32
    record("A9", sdpa_pallas.KERNEL_A9, "flash_sm90.cuh", "sdpa_pallas.py:36", *worst[1:],
           " (the bf16 case nearest its limit)")
    # A9's float32 arm (precision="highest"), on the same inputs in float32
    record("A9-f32", sdpa_pallas.KERNEL_A9, "flash_f32_sm90.cuh", "sdpa_pallas.py:36", worst_f32, f32_tol,
           f" (the float32 arm, softmax=exact; queries 0-127 {worst_f64:.3e} from float64)")
    a9_inputs = qkv((LONG_BATCH, heads, long_frames, 64), torch.bfloat16, gen_a9)
    del q9, k9, v9

    # A15 at one 820 s pair's shape (2 x 12 x 40 999 x 64, bf16), every
    # query, in the per-row class: the plain version walks key blocks of 128
    # as the kernel does, so it never holds the (T, T) logits (161 GB in
    # float32)
    flash_frames = FLASH_SECONDS * RATE // 320 - 1
    a15_inputs = qkv((2, heads, flash_frames, 64), torch.bfloat16, gen_a15)
    worst = context_err(sdpa_pallas.flash_sdpa(*a15_inputs, 0.125), sdpa_pallas._flash_sdpa_plain(*a15_inputs, 0.125),
                        f"A15 2x{heads}x{flash_frames}x64", (0.0, 0.0, 1.0))
    record("A15", sdpa_pallas.KERNEL_A15, "flash_sm90.cuh", "models/hubert.py:157", *worst[1:],
           " (the upstream flash_attention kernel that _flash_sdpa calls)")
    # A15's float32 arm (precision="highest") on the same q, k, v in float32
    a15_f32 = [a.float() for a in a15_inputs]
    got_f32 = sdpa_pallas.flash_sdpa(*a15_f32, 0.125)
    want_f32 = sdpa_pallas._flash_sdpa_plain(*a15_f32, 0.125)
    what = f"A15 2x{heads}x{flash_frames}x64 float32"
    err = f32_err(got_f32, want_f32, what)
    err64 = f64_err(got_f32, want_f32, *a15_f32, 0.125, what)
    record("A15-f32", sdpa_pallas.KERNEL_A15, "flash_f32_sm90.cuh", "models/hubert.py:157", err, f32_tol,
           f" (the float32 arm, online softmax; queries 0-127 {err64:.3e} from float64)")
    del a15_f32, got_f32, want_f32
    # the float32 arms' split pass, bit for bit its plain version, on A9's
    # float32 inputs
    a9_f32 = [a.float() for a in a9_inputs]
    got_p, want_p = sdpa_pallas.split_pieces(*a9_f32), sdpa_pallas._split_pieces_plain(*a9_f32)
    err = torch.max(torch.abs(got_p.float() - want_p.float())).item()
    check(torch.equal(got_p.view(torch.int16), want_p.view(torch.int16)),
          "the float32 arms' split pass differs from its plain version")
    record("A9-f32-split", sdpa_pallas.KERNEL_SPLIT, "sdr_halves.cuh", "sdpa_pallas.py:36", err, 0.0,
           " (the float32 arms' split pass, bit for bit)")
    del a9_f32, got_p, want_p

    # FE: convs 1-6 of mHuBERT-147's conv encoder at 64 x 16 s, each
    # kernel launch against the plain version on the same input (the plain
    # chain's), over the plain output's largest magnitude; conv 1 on two
    # rows also against a float64 conv, within twice cuDNN float32's distance
    fe_x, fe_w, fe_pieces = fe_inputs(dev)
    worst, x_ = 0.0, fe_x
    for w_, p_ in zip(fe_w, fe_pieces):
        got = conv_gelu.conv_gelu(x_, w_, "tanh", pieces=p_)
        x_ = conv_gelu._conv_gelu_plain(x_, w_, "tanh")
        worst = max(worst, ((got - x_).abs().max() / x_.abs().max()).item())
    want64 = conv_gelu._gelu(torch.nn.functional.conv1d(fe_x[:2].double(), fe_w[0].double(), stride=2), "tanh")

    def from64(y):
        return ((y.double() - want64).abs().max() / want64.abs().max()).item()

    fe64 = from64(conv_gelu.conv_gelu(fe_x[:2], fe_w[0], "tanh", pieces=fe_pieces[0]))
    lib64 = from64(conv_gelu._conv_gelu_plain(fe_x[:2], fe_w[0], "tanh"))
    check(fe64 <= 2 * lib64, f"FE conv 1 from float64 {fe64:.3e}, over twice cuDNN float32's {lib64:.3e}")
    record("FE", conv_gelu.KERNEL, "conv_gelu.cu", "models/hubert.py:120", worst, 1e-5,
           f" (convs 1-6 at 64 x 16 s, over max|plain|; conv 1 on 2 rows from float64: {fe64:.3e}, "
           f"cuDNN float32 {lib64:.3e})")
    del fe_x, fe_w, fe_pieces, got, x_, want64

    # A10 on the normalised signals, as SDR(corr_impl="fused") feeds it: the
    # raw variant at 64 x 16 s, the padded one at 64 x (16 s + 100); atol
    # 2e-4 * max|r_auto|, as A4
    def normalised(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)

    a10_inputs = {"A10r": (normalised(c), normalised(d)),
                  "A10": (normalised(unaligned["A2"][2]), normalised(torch.from_numpy(unaligned["A2"][1]).to(dev)))}
    for kid, (cn, dn) in a10_inputs.items():
        ra_k, rc_k = sdr_corr_fused.correlation_lags_fused(cn, dn, LAGS)
        ra_p, rc_p = sdr_corr_fused._correlation_lags_fused_plain(cn, dn, LAGS)
        scale = torch.max(torch.abs(ra_p)).item()
        err = max(torch.max(torch.abs(ra_k - ra_p)).item(), torch.max(torch.abs(rc_k - rc_p)).item())
        kname, line = ((sdr_corr_fused.KERNEL_A10_RAW, "sdr_corr_fused.py:131") if kid == "A10r"
                       else (sdr_corr_fused.KERNEL_A10, "sdr_corr_fused.py:64"))
        record(kid, kname, "sdr_corr_fused.cu", line, err, 2e-4 * scale, f" ({cn.shape[1]} samples)")

    # -- 4. main path -----------------------------------------------------------
    phase("main path")
    metrics = {
        "LSD": pkg.LSD(),
        "SDR": pkg.SDR(),
        "STOI": pkg.STOI(sample_rate=RATE),
    }
    def drive(fn, what, kernels):
        """Run one main path with every launch count set to 0 before it;
        each of ``kernels`` must have launched."""
        torch.cuda.synchronize()
        cuda_lib.launch_counts.clear()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(cuda_lib.launch_counts)
        log(f"{what} launches: {counts}")
        for kid in kernels:
            kname = results[kid]["name"]
            check(counts.get(kname, 0) >= 1, f"{kid} {kname} was not launched on the {what} path")
            results[kid]["launches"] = counts.get(kname, 0)
        return out

    scores = drive(lambda: {name: m(clean_np, noisy_np) for name, m in metrics.items()},
                   "main path (LSD, SDR, STOI)", ("A1", "A4", "A5", "A6"))

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

    # LSD of clips that are not hop-aligned: A2, then A3 past 1023 frames
    for kid, (c_np, d_np, _, _) in unaligned.items():
        rows = drive(lambda: metrics["LSD"](c_np, d_np), f"LSD {c_np.shape[1]} samples", (kid,))
        cpu_rows = pkg.LSD(device="cpu")(c_np[:CPU_ROWS], d_np[:CPU_ROWS])
        vals = np.array([r["LSD"] for r in rows])
        check(len(rows) == BATCH and bool(np.all(np.isfinite(vals))), f"LSD {kid}: bad scores")
        worst = max(abs(a["LSD"] - b["LSD"]) - 2e-4 * abs(b["LSD"]) for a, b in zip(rows, cpu_rows))
        check(worst <= 2e-4, f"LSD {kid}: card vs CPU beyond rtol/atol 2e-4")
        log(f"LSD {c_np.shape[1]} samples ({kid}): batch mean {vals.mean()}; card vs CPU plain "
            f"path on {CPU_ROWS} rows within rtol/atol 2e-4")

    # SpeechBERTScore at mHuBERT-147's full width, seeded random weights:
    # 8 layers x 2 row chunks of the doubled batch -> 16 launches each of A7, A8
    sbs_params = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    sbs = pkg.SpeechBERTScore(params=sbs_params)
    sbs_rows = drive(lambda: sbs(clean_np, noisy_np), "SpeechBERTScore", ("A7", "A8", "FE"))
    for kid, want in (("A7", sbs.output_layer * 2), ("A8", sbs.output_layer * 2), ("FE", 6 * 2)):
        check(results[kid]["launches"] == want,
              f"{kid}: {results[kid]['launches']} launches, expected {want}")
    f1 = np.array([r["SpeechBERTScore"] for r in sbs_rows])
    check(len(f1) == BATCH and bool(np.all(np.isfinite(f1))) and bool(np.all(np.abs(f1) <= 1.0 + 1e-6)),
          "SpeechBERTScore: bad scores")
    t0 = time.perf_counter()
    sbs_cpu = pkg.SpeechBERTScore(params=sbs_params, device="cpu", attention_impl="block_ffn")
    cpu_f1 = np.array([r["SpeechBERTScore"] for r in sbs_cpu(clean_np[:SBS_CPU_ROWS], noisy_np[:SBS_CPU_ROWS])])
    cpu_s = time.perf_counter() - t0
    dev_cpu = float(np.max(np.abs(f1[:SBS_CPU_ROWS] - cpu_f1)))
    check(dev_cpu <= 2e-4, f"SpeechBERTScore: card vs CPU plain path {dev_cpu:.3e} (atol 2e-4)")
    exact = pkg.SpeechBERTScore(params=sbs_params, precision="highest")
    exact_f1 = np.array([r["SpeechBERTScore"] for r in exact(clean_np[:SBS_CPU_ROWS], noisy_np[:SBS_CPU_ROWS])])
    dev_fp32 = float(np.max(np.abs(f1[:SBS_CPU_ROWS] - exact_f1)))
    check(dev_fp32 <= 2e-3, f"SpeechBERTScore: block path vs the card's float32 path {dev_fp32:.3e} (atol 2e-3)")
    log(f"SpeechBERTScore: batch mean {f1.mean()}; card vs CPU plain path on {SBS_CPU_ROWS} rows: "
        f"max diff {dev_cpu:.3e} (atol 2e-4; the CPU took {cpu_s:.1f} s); vs the card's float32 "
        f"einsum path (precision='highest'): {dev_fp32:.3e} (atol 2e-3)")
    del sbs_cpu, exact

    def f1_of(rows, n):
        f1_ = np.array([r["SpeechBERTScore"] for r in rows])
        check(len(f1_) == n and bool(np.all(np.isfinite(f1_))) and bool(np.all(np.abs(f1_) <= 1.0 + 1e-6)),
              "SpeechBERTScore: bad scores")
        return f1_

    def only(kernels, what):
        """The last driven path launched exactly ``kernels`` (name -> count) of the attention kernels."""
        counts = dict(cuda_lib.launch_counts)
        for kname, n in kernels.items():
            check(counts.get(kname, 0) == n, f"{what}: {counts.get(kname, 0)} launches of {kname}, expected {n}")

    attn_kernels = (attn_block_pallas.KERNEL_A7, attn_block_pallas.KERNEL_A8,
                    sdpa_pallas.KERNEL_A9, sdpa_pallas.KERNEL_A15)

    # the whole-layer (A11) and int8 (A12) paths on the 16 s batch: one
    # launch per layer and row chunk, no A7 / A8; F1 against the CPU plain
    # path of the same impl (atol 2e-4); A11's also equal to the A7 + A8
    # path's above (the same launches on the same operands), A12's only
    # logged against it (the int8 screening mode is another function)
    for kid, impl in (("A11", "layer_block"), ("A12", "block_int8")):
        metric = pkg.SpeechBERTScore(params=sbs_params, attention_impl=impl)
        f1_i = f1_of(drive(lambda: metric(clean_np, noisy_np), f"SpeechBERTScore {impl}", (kid,)), BATCH)
        only({results[kid]["name"]: 2 * sbs.output_layer, attn_block_pallas.KERNEL_A7: 0,
              attn_block_pallas.KERNEL_A8: 0}, f"SpeechBERTScore {impl}")
        t0 = time.perf_counter()
        cpu_i = pkg.SpeechBERTScore(params=sbs_params, device="cpu", attention_impl=impl)
        cpu_f1 = f1_of(cpu_i(clean_np[:SBS_CPU_ROWS], noisy_np[:SBS_CPU_ROWS]), SBS_CPU_ROWS)
        cpu_s = time.perf_counter() - t0
        dev_cpu = float(np.max(np.abs(f1_i[:SBS_CPU_ROWS] - cpu_f1)))
        check(dev_cpu <= 2e-4, f"SpeechBERTScore {impl}: card vs CPU plain path {dev_cpu:.3e} (atol 2e-4)")
        vs_block = float(np.max(np.abs(f1_i - f1)))
        if kid == "A11":  # the default softmax (exp2) on both paths, A11 bit-equal to A7 then A8
            check(vs_block == 0.0, f"SpeechBERTScore layer_block vs block_ffn on the card {vs_block:.3e} (not equal)")
        log(f"SpeechBERTScore {impl}: batch mean {f1_i.mean()}; card vs CPU plain path on {SBS_CPU_ROWS} rows: "
            f"max diff {dev_cpu:.3e} (atol 2e-4; the CPU took {cpu_s:.1f} s); vs the A7 + A8 path on the card: "
            f"max diff {vs_block:.3e}")
        del metric, cpu_i

    # lsd_scores(..., dft_impl="ct") on the 16 s batch: A13 once, A1 never;
    # against A1's scores (phase 3) and the CPU plain path, rtol/atol 2e-4
    ct_scores = drive(lambda: lsd_fused.lsd_scores(c, d, 2 * HOP, HOP, EPS, denoised_scale="auto", dft_impl="ct"),
                      "lsd_scores dft_impl='ct'", ("A13",))
    only({lsd_fused.KERNEL_A13: 1, lsd_fused.KERNEL: 0}, "lsd_scores dft_impl='ct'")
    check(ct_scores.shape == (BATCH,) and bool(torch.all(torch.isfinite(ct_scores))), "LSD ct: bad scores")
    ct_cpu = lsd_fused.lsd_scores(c[:CPU_ROWS].cpu(), d[:CPU_ROWS].cpu(), 2 * HOP, HOP, EPS, dft_impl="ct")
    dev_a1 = torch.max(torch.abs(ct_scores - lsd_k) - 2e-4 * torch.abs(lsd_k)).item()
    dev_cpu = torch.max(torch.abs(ct_scores[:CPU_ROWS].cpu() - ct_cpu) - 2e-4 * torch.abs(ct_cpu)).item()
    check(dev_a1 <= 2e-4 and dev_cpu <= 2e-4, "LSD ct: card vs A1 or the CPU plain path beyond rtol/atol 2e-4")
    log(f"lsd_scores dft_impl='ct': batch mean {ct_scores.mean().item()}; vs A1 and the CPU plain path on "
        f"{CPU_ROWS} rows within rtol/atol 2e-4 (excess {dev_a1:.3e}, {dev_cpu:.3e})")

    # each Levinson variant through levinson_solve_fused on the 64 x 512
    # systems: one launch of its own kernel and none of the others; the
    # first rows against the CPU plain path at 2e-3 of max|x|
    for variant, kid in a14_ids.items():
        xv = drive(lambda: levinson_pallas.levinson_solve_fused(r0n, bn, variant=variant),
                   f"levinson_solve_fused variant={variant}", (kid,))
        only({levinson_pallas.KERNELS[v]: int(v == variant) for v in levinson_pallas.VARIANTS},
             f"levinson_solve_fused variant={variant}")
        xc = levinson_pallas.levinson_solve_fused(r0n[:CPU_ROWS].cpu(), bn[:CPU_ROWS].cpu(), variant=variant)
        rel = (torch.max(torch.abs(xv[:CPU_ROWS].cpu() - xc)) / torch.max(torch.abs(xc))).item()
        check(math.isfinite(rel) and rel <= 2e-3, f"{kid}: card vs CPU plain path {rel:.2e} of max|x| (2e-3)")
        log(f"levinson_solve_fused variant={variant}: card vs CPU plain path on {CPU_ROWS} rows {rel:.2e} of max|x|")

    # 16 x 60 s: 32 doubled rows of 2999 frames, auto-chunked into 2 x 16
    # rows -> A9 once per layer and chunk, no A7 / A8
    c60_np, d60_np, _ = load_audio_data(LONG_SECONDS, LONG_BATCH, RATE)
    t0 = time.perf_counter()
    f1_60 = f1_of(drive(lambda: sbs(c60_np, d60_np), f"SpeechBERTScore {LONG_BATCH} x {LONG_SECONDS} s", ("A9",)),
                  LONG_BATCH)
    first_s = time.perf_counter() - t0
    only(dict(zip(attn_kernels, (0, 0, 2 * sbs.output_layer, 0))), "SpeechBERTScore 16 x 60 s")
    t0 = time.perf_counter()
    cpu60 = pkg.SpeechBERTScore(params=sbs_params, device="cpu", attention_impl="sdpa")
    cpu_f1 = f1_of(cpu60(c60_np[:1], d60_np[:1]), 1)
    cpu_s = time.perf_counter() - t0
    dev_cpu = float(np.max(np.abs(f1_60[:1] - cpu_f1)))
    check(dev_cpu <= 2e-4, f"SpeechBERTScore 60 s: card vs CPU plain path {dev_cpu:.3e} (atol 2e-4)")
    exact60 = pkg.SpeechBERTScore(params=sbs_params, precision="highest")
    dev_fp32 = float(np.max(np.abs(f1_60[:1] - f1_of(drive(lambda: exact60(c60_np[:1], d60_np[:1]),
                                                           "SpeechBERTScore 1 x 60 s, precision='highest'",
                                                           ("A9-f32", "A9-f32-split")), 1))))
    check(dev_fp32 <= 2e-3, f"SpeechBERTScore 60 s: bf16 A9 path vs the card's float32 A9 path {dev_fp32:.3e} "
                            "(atol 2e-3)")
    log(f"SpeechBERTScore {LONG_BATCH} x {LONG_SECONDS} s: batch mean {f1_60.mean()} (first call {first_s:.1f} s); "
        f"card vs CPU plain path on 1 pair: {dev_cpu:.3e} (atol 2e-4; the CPU took {cpu_s:.1f} s); vs the "
        f"card's float32 path (precision='highest', A9's float32 arm): {dev_fp32:.3e} (atol 2e-3)")
    del cpu60, exact60

    # one pair of 820 s clips, 40 999 frames: "auto" takes A15 once per
    # layer; the same pair on A9's exact softmax for agreement
    c820_np, d820_np, _ = load_audio_data(FLASH_SECONDS, 1, RATE)
    torch.cuda.empty_cache()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f1_820 =f1_of(drive(lambda: sbs(c820_np, d820_np), f"SpeechBERTScore 1 x {FLASH_SECONDS} s", ("A15",)), 1)
    flash_s = time.perf_counter() - t0
    peak_820 = torch.cuda.max_memory_allocated() / 2**30
    only(dict(zip(attn_kernels, (0, 0, 0, sbs.output_layer))), "SpeechBERTScore 820 s")
    exact820 = pkg.SpeechBERTScore(params=sbs_params, attention_impl="sdpa", softmax="exact")
    t0 = time.perf_counter()
    f1_820_sdpa = f1_of(exact820(c820_np, d820_np), 1)
    sdpa_s = time.perf_counter() - t0
    dev_820 = float(np.max(np.abs(f1_820 - f1_820_sdpa)))
    check(dev_820 <= 2e-4, f"SpeechBERTScore 820 s: flash path vs exact sdpa path {dev_820:.3e} (atol 2e-4)")
    log(f"SpeechBERTScore 1 x {FLASH_SECONDS} s: F1 {f1_820[0]} in {flash_s:.2f} s (peak device memory "
        f"{peak_820:.2f} GiB); the exact sdpa path (A9) {f1_820_sdpa[0]} in {sdpa_s:.2f} s: diff {dev_820:.3e} "
        "(atol 2e-4)")
    # the same pair at precision="highest": A15's float32 arm once per
    # layer, within the bf16 paths' 2e-3 of it
    exact820 = pkg.SpeechBERTScore(params=sbs_params, precision="highest")
    t0 = time.perf_counter()
    f1_820_f32 = f1_of(drive(lambda: exact820(c820_np, d820_np), f"SpeechBERTScore 1 x {FLASH_SECONDS} s, "
                             "precision='highest'", ("A15-f32", "A9-f32-split")), 1)
    f32_s = time.perf_counter() - t0
    only(dict(zip(attn_kernels, (0, 0, 0, sbs.output_layer))), "SpeechBERTScore 820 s precision='highest'")
    dev_820 = float(np.max(np.abs(f1_820 - f1_820_f32)))
    check(dev_820 <= 2e-3, f"SpeechBERTScore 820 s: bf16 A15 path vs the float32 one {dev_820:.3e} (atol 2e-3)")
    log(f"SpeechBERTScore 1 x {FLASH_SECONDS} s, precision='highest' (A15's float32 arm): F1 {f1_820_f32[0]} in "
        f"{f32_s:.2f} s; vs the bf16 flash path {dev_820:.3e} (atol 2e-3)")
    del exact820

    # SDR(corr_impl="fused"): A10's raw variant on the 16 s batch, its padded
    # one on 16 s + 100; against the CPU plain path and SDR() at 1e-2 dB
    sdr_fused = pkg.SDR(corr_impl="fused")
    for kid, (c_np, d_np) in (("A10r", (clean_np, noisy_np)), ("A10", unaligned["A2"][:2])):
        rows = drive(lambda: sdr_fused(c_np, d_np), f"SDR fused {c_np.shape[1]} samples", (kid,))
        vals = np.array([r["SDR"] for r in rows])
        check(len(rows) == BATCH and bool(np.all(np.isfinite(vals))), f"SDR fused {kid}: bad scores")
        ref = np.array([r["SDR"] for r in metrics["SDR"](c_np, d_np)])
        cpu = np.array([r["SDR"] for r in pkg.SDR(device="cpu", corr_impl="fused")(c_np[:CPU_ROWS], d_np[:CPU_ROWS])])
        dev_ref, dev_cpu = float(np.max(np.abs(vals - ref))), float(np.max(np.abs(vals[:CPU_ROWS] - cpu)))
        check(dev_ref <= 1e-2 and dev_cpu <= 1e-2,
              f"SDR fused {kid}: vs SDR() {dev_ref:.3e} dB, vs the CPU plain path {dev_cpu:.3e} dB (atol 1e-2)")
        log(f"SDR fused {c_np.shape[1]} samples ({kid}): batch mean {vals.mean()}; vs SDR() on the card "
            f"{dev_ref:.3e} dB, vs the CPU plain path on {CPU_ROWS} rows {dev_cpu:.3e} dB (atol 1e-2)")

    # SDR(corr_impl="gram" | "gram_x1"): A4 once in split x3 / x1 and never
    # in x4; against the CPU plain path of the same mode at 1e-2 dB, and
    # logged against SDR() (x1 is the JAX package's screening class)
    for impl, split in (("gram", "x3"), ("gram_x1", "x1")):
        kid = f"A4-{split}"
        rows = drive(lambda: pkg.SDR(corr_impl=impl)(clean_np, noisy_np), f"SDR corr_impl={impl!r}", (kid,))
        only({sdr_corr_gram.KERNELS[s_]: int(s_ == split) for s_ in sdr_corr_gram.KERNELS}, f"SDR {impl}")
        vals = np.array([r["SDR"] for r in rows])
        check(len(rows) == BATCH and bool(np.all(np.isfinite(vals))), f"SDR {impl}: bad scores")
        cpu = np.array([r["SDR"] for r in pkg.SDR(device="cpu", corr_impl=impl)(clean_np[:CPU_ROWS], noisy_np[:CPU_ROWS])])
        dev_cpu = float(np.max(np.abs(vals[:CPU_ROWS] - cpu)))
        check(dev_cpu <= 1e-2, f"SDR {impl}: vs the CPU plain path {dev_cpu:.3e} dB (atol 1e-2)")
        vs_x4 = float(np.max(np.abs(vals - np.array([r["SDR"] for r in scores["SDR"]]))))
        log(f"SDR corr_impl={impl!r}: batch mean {vals.mean()}; vs the CPU plain path on {CPU_ROWS} rows "
            f"{dev_cpu:.3e} dB (atol 1e-2); vs SDR() (split x4) {vs_x4:.3e} dB")

    phase("main path: PESQ, DNSMOS")
    # PESQ and DNSMOS: no Pallas kernel on their paths in the JAX package, so
    # none here (cuBLAS / cuDNN float32, TF32 off) and no launch counted; the
    # first rows against the CPU plain path, PESQ at abs 1e-3 MOS, DNSMOS at
    # 5e-4
    pesq_m, dnsmos_m = pkg.PESQ(), pkg.DNSMOS()
    pd_scores = drive(lambda: {"PESQ": pesq_m(clean_np, noisy_np), "DNSMOS": dnsmos_m(clean_np, noisy_np)},
                      "main path (PESQ, DNSMOS)", ())
    check(not any(cuda_lib.launch_counts.values()), "PESQ / DNSMOS launched a kernel of the package")
    dns_keys = ("SIG", "BAK", "OVRL")

    def score_rows(rows, keys, n):
        vals = np.array([[r[k] for k in keys] for r in rows])
        check(vals.shape == (n, len(keys)) and bool(np.all(np.isfinite(vals))), f"{keys}: bad scores")
        return vals

    pesq_vals = score_rows(pd_scores["PESQ"], ("PESQ",), BATCH)
    dns_vals = score_rows(pd_scores["DNSMOS"], dns_keys, BATCH)
    check(bool(np.all((pesq_vals > 0.99) & (pesq_vals < 4.56))) and bool(np.all((dns_vals >= 1) & (dns_vals <= 5))),
          "PESQ / DNSMOS: scores out of range")
    for name, vals, keys, tol in (("PESQ", pesq_vals, ("PESQ",), 1e-3), ("DNSMOS", dns_vals, dns_keys, 5e-4)):
        t0 = time.perf_counter()
        cpu_vals = score_rows(getattr(pkg, name)(device="cpu")(clean_np[:CPU_ROWS], noisy_np[:CPU_ROWS]), keys,
                              CPU_ROWS)
        cpu_s = time.perf_counter() - t0
        dev_cpu = float(np.max(np.abs(vals[:CPU_ROWS] - cpu_vals)))
        check(dev_cpu <= tol, f"{name}: card vs CPU plain path {dev_cpu:.3e} (atol {tol})")
        log(f"{name}: batch mean {vals.mean(axis=0).tolist()}; card vs CPU plain path on {CPU_ROWS} rows: "
            f"max diff {dev_cpu:.3e} (atol {tol}; the CPU took {cpu_s:.1f} s)")
    rows = dnsmos_m._shared_chunk_rows(BATCH, dnsmos_m._tile_to_window(d).shape[1] // 160 - 1)
    log(f"DNSMOS shared_exact: {1 if rows is None else -(-BATCH // rows)} trunk chunk(s) of "
        f"{BATCH if rows is None else rows} rows at {BATCH} x {SECONDS} s (6 GB rule on the conv0 map)")
    # precision="highest" is the same float32 function on the card; the bf16
    # trunk within the JAX package's bf16 class of it; the per-window plan on
    # 4 rows against shared_exact at 1e-4 (cuDNN picks its algorithms by
    # shape, so the gap is printed)
    dns_highest = score_rows(pkg.DNSMOS(precision="highest")(None, noisy_np), dns_keys, BATCH)
    dev_h = float(np.max(np.abs(dns_highest - dns_vals)))
    check(dev_h <= 1e-5, f"DNSMOS precision='highest' vs default on the card {dev_h:.3e} (atol 1e-5)")
    dnsmos_bf16 = pkg.DNSMOS(conv_dtype=torch.bfloat16)
    dns_bf16 = score_rows(dnsmos_bf16(None, noisy_np), dns_keys, BATCH)
    bf16_err = np.max(np.abs(dns_bf16 - dns_highest), axis=0)
    check(bool(np.all(bf16_err <= np.array([0.04, 0.04, 0.02]))),
          f"DNSMOS conv_dtype=bfloat16 vs 'highest' {bf16_err.tolist()} (atol 0.04 / 0.04 / 0.02)")
    dns_pw = score_rows(pkg.DNSMOS(window_plan="per_window")(None, noisy_np[:CPU_ROWS]), dns_keys, CPU_ROWS)
    dev_pw = float(np.max(np.abs(dns_pw - dns_vals[:CPU_ROWS])))
    check(dev_pw <= 1e-4, f"DNSMOS per_window vs shared_exact on the card {dev_pw:.3e} (atol 1e-4)")
    log(f"DNSMOS: precision='highest' vs default {dev_h:.3e} (atol 1e-5); conv_dtype=bfloat16 vs 'highest' "
        f"SIG / BAK / OVRL {bf16_err.tolist()} (atol 0.04 / 0.04 / 0.02); window_plan='per_window' vs "
        f"shared_exact on {CPU_ROWS} rows {dev_pw:.3e} (atol 1e-4)")
    # PESQ(time_align=True) on the batch delayed by SHIFT samples: every row
    # shifted back exactly, the scores within 0.1 of the undelayed ones (the
    # zero-filled tail) and the first rows at 1e-3 of the CPU plain path
    delayed_np = np.concatenate([np.zeros_like(noisy_np[:, :SHIFT]), noisy_np[:, :-SHIFT]], axis=1)
    pesq_al = pkg.PESQ(time_align=True)
    al_vals = score_rows(drive(lambda: pesq_al(clean_np, delayed_np), "PESQ time_align=True", ()), ("PESQ",), BATCH)
    back = pesq_al._align_delay(c, torch.from_numpy(delayed_np).to(dev))
    exact = int(torch.sum(torch.all(back[:, :-SHIFT] == d[:, :-SHIFT], dim=1)).item())
    check(exact == BATCH, f"PESQ time_align: {exact} of {BATCH} rows shifted back exactly")
    cpu_al = score_rows(pkg.PESQ(device="cpu", time_align=True)(clean_np[:CPU_ROWS], delayed_np[:CPU_ROWS]),
                        ("PESQ",), CPU_ROWS)
    dev_al, dev_base = float(np.max(np.abs(al_vals[:CPU_ROWS] - cpu_al))), float(np.max(np.abs(al_vals - pesq_vals)))
    check(dev_al <= 1e-3 and dev_base <= 0.1,
          f"PESQ time_align: card vs CPU {dev_al:.3e} (atol 1e-3), vs the undelayed scores {dev_base:.3e} (atol 0.1)")
    log(f"PESQ time_align=True on a {SHIFT}-sample delay: {exact} of {BATCH} rows shifted back exactly; card vs CPU "
        f"plain path on {CPU_ROWS} rows {dev_al:.3e} (atol 1e-3); vs PESQ() on the undelayed batch {dev_base:.3e} "
        "(atol 0.1)")

    public_api_phase(pkg, sbs, sbs_params, f1, clean_np, noisy_np)

    # -- 5. times ---------------------------------------------------------------
    phase("times")
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

    # x3 / x1: one grouped conv1d over the bf16 halves, computed before the
    # call (the split itself is not in the yardstick); per group the input
    # channels [yh, yl, yh] against the filters [ch, ch, cl] (x3) or yh
    # against ch (x1), summed over the channels as the split product is
    c_h, c_l = sdr_corr_gram._hi_lo(c)
    d_h, d_l = sdr_corr_gram._hi_lo(d)
    split_library = {}
    for split, ys, fs in (("x3", ((c_h, c_l, c_h), (d_h, d_l, d_h)), ((c_h, c_h, c_l),) * 2),
                          ("x1", ((c_h,), (d_h,)), ((c_h,),) * 2)):
        ch_in = torch.nn.functional.pad(torch.cat([torch.stack(y, dim=1) for y in ys], dim=0).reshape(
            1, -1, t_len), (0, LAGS - 1))
        filt = torch.cat([torch.stack(f, dim=1) for f in fs], dim=0)  # (2B, channels, T)

        def split_conv(ch_in=ch_in, filt=filt):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.nn.functional.conv1d(ch_in, filt, groups=2 * BATCH)

        split_library[split] = split_conv

    n_seg_total = float(nseg.sum().item())
    f_len = tob_c.shape[1]
    # Operation counts. "ops" is the least the function needs: FFT-level
    # counts for the spectra and correlations (log and sqrt one operation
    # each). "direct" is what the kernel's own algorithm does, where that is
    # more: A1-A3's bf16x6 chunk DFT (six 256 x 512 products per chunk and
    # signal, chunks -1 .. F - 1), A4's shifted Grams (128 x 1280 per frame
    # and bf16 term) and A10's bf16x3 chunk DFT on the bf16 tensor cores.
    frames = nc + 1
    a1_ops = (2 * BATCH * frames * (rfft_flops(2 * HOP) + 2 * HOP)  # windowed 512-point spectra
              + BATCH * frames * (HOP + 1) * 14  # |C|^2 / (|D| + eps)^2, log, square, sum
              + 4 * BATCH * t_len)  # projection-scale sums
    a1_direct = 2 * BATCH * (frames + 1) * HOP * 2 * HOP * 2 * 6

    def lsd_bytes(n):
        """the signals read once, the scores"""
        return 2 * BATCH * n * 4 + BATCH * 4

    k_blocks = -(-t_len // LAGS)  # overlap-save as in ops/dft.py::correlation_lags
    a4_ops = BATCH * ((2 * k_blocks + 1) * rfft_flops(2 * LAGS)  # chunk spectra of c and d
                      + k_blocks * (LAGS + 1) * (4 + 2 * 8)  # window combine, two products
                      + 2 * rfft_flops(2 * LAGS))  # two inverse transforms
    a4_direct = 2 * 128 * 10 * 128 * -(-t_len // 128) * BATCH  # one bf16 term; x3 three, x4 four
    # x3: the chunk spectra of four half signals and three products per
    # correlation, plus the splits (4 operations a sample and signal); x1:
    # two half signals, one product each, and the splits
    a4_x3_ops = BATCH * ((4 * k_blocks + 2) * rfft_flops(2 * LAGS) + k_blocks * (LAGS + 1) * (8 + 6 * 8)
                         + 2 * rfft_flops(2 * LAGS) + 8 * t_len)
    a4_x1_ops = a4_ops + BATCH * 4 * t_len
    a5_ops = 12 * LAGS * (LAGS - 1) * BATCH  # per step: two dot products, four axpys
    # per valid segment: ~30 flops per (band, frame) over 15 x 30, plus ~15
    # per frame for the ESTOI band normalisation
    a6_ops = n_seg_total * 30 * (15 * 30 + 15)
    timing = {
        "A1": (lambda: lsd_fused.lsd_wholesig_raw(c, d, HOP, EPS),
               lambda: lsd_fused._lsd_wholesig_raw_plain(c, d, HOP, EPS), None,
               a1_ops, a1_direct, lsd_bytes(t_len)),
        "A4": (lambda: sdr_corr_gram.correlation_lags_gram(c, d, LAGS),
               lambda: sdr_corr_gram._correlation_lags_plain(c, d, LAGS), corr_library,
               a4_ops, 4 * a4_direct, 2 * BATCH * t_len * 4 + 2 * BATCH * LAGS * 4),
        "A4-x3": (lambda: sdr_corr_gram.correlation_lags_gram(c, d, LAGS, "x3"),
                  lambda: sdr_corr_gram._correlation_lags_plain(c, d, LAGS, "x3"), split_library["x3"],
                  a4_x3_ops, 3 * a4_direct, 2 * BATCH * t_len * 4 + 2 * BATCH * LAGS * 4),
        "A4-x1": (lambda: sdr_corr_gram.correlation_lags_gram(c, d, LAGS, "x1"),
                  lambda: sdr_corr_gram._correlation_lags_plain(c, d, LAGS, "x1"), split_library["x1"],
                  a4_x1_ops, a4_direct, 2 * BATCH * t_len * 4 + 2 * BATCH * LAGS * 4),
        "A5": (lambda: levinson_pallas.levinson_solve_fused(r0n, bn),
               lambda: toeplitz.levinson_solve(r0n, bn),
               lambda: torch.linalg.solve(toeplitz_full, bn[..., None]),
               a5_ops, a5_ops, 3 * BATCH * LAGS * 4),
        "A6": (lambda: stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg),
               lambda: stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15), None,
               a6_ops, a6_ops, 2 * BATCH * f_len * 15 * 4 + BATCH * 4 + 2 * BATCH * 4),
    }
    for kid, (_, _, cu, ds) in unaligned.items():
        n = cu.shape[1]
        f_n = 1 + n // HOP
        wrapper = lsd_fused.lsd_wholesig if kid == "A2" else lsd_fused.lsd_framed
        plain = lsd_fused._lsd_wholesig_plain if kid == "A2" else lsd_fused._lsd_framed_plain
        timing[kid] = (
            lambda w=wrapper, cu=cu, ds=ds: w(cu, ds, HOP, EPS),
            lambda p=plain, cu=cu, ds=ds: p(cu, ds, HOP, EPS), None,
            2 * BATCH * f_n * (rfft_flops(2 * HOP) + 2 * HOP) + BATCH * f_n * (HOP + 1) * 14,
            2 * BATCH * (f_n + 1) * HOP * 2 * HOP * 2 * 6,
            lsd_bytes(n),
        )

    # A7 / A8 at the main path's mode (exp2, tanh); the library yardstick is
    # a composite of PyTorch calls (bf16 F.linear, scaled_dot_product_attention,
    # F.layer_norm), timed here and used nowhere in the port
    fn = torch.nn.functional
    rows_t = BATCH * blk_frames
    wq_e, bq_e, wo_e, bo_e, ln_s, ln_b = packed["exact"]
    lin = {"qkv": wq_e.t().contiguous(), "o": wo_e.t().contiguous(),
           "w1": ffn_packed[0].t().contiguous(), "w2": ffn_packed[2].t().contiguous()}

    def a7_library():
        xb = x_blk.to(torch.bfloat16)
        qkv = fn.linear(xb, lin["qkv"], bq_e.to(torch.bfloat16))
        q, k, v = qkv.view(BATCH, blk_frames, 3, heads, -1).permute(2, 0, 3, 1, 4)
        ctx = fn.scaled_dot_product_attention(q, k, v, scale=1.0)  # q carries the scale
        out = fn.linear(ctx.transpose(1, 2).reshape(BATCH, blk_frames, d_model), lin["o"], bo_e.to(torch.bfloat16))
        return fn.layer_norm((out + xb).float(), (d_model,), ln_s, ln_b, cfg.layer_norm_eps)

    def a8_library(x_in=x_blk):
        xb = x_in.to(torch.bfloat16)
        h = fn.gelu(fn.linear(xb, lin["w1"], ffn_packed[1].to(torch.bfloat16)), approximate="tanh")
        out = fn.linear(h, lin["w2"], ffn_packed[3].to(torch.bfloat16))
        return fn.layer_norm((out + xb).float(), (d_model,), ffn_packed[4], ffn_packed[5], cfg.layer_norm_eps)

    a7_ops = BATCH * (2 * blk_frames * d_model * 3 * d_model + 4 * blk_frames * blk_frames * d_model
                      + 2 * blk_frames * d_model * d_model)
    a8_ops = BATCH * 4 * blk_frames * d_model * ffn
    io_bytes = 2 * rows_t * d_model * 4  # x in and y out, float32 as the main path passes them
    timing["A7"] = (
        lambda: attn_block_pallas.attn_block(x_blk, packed["exp2"], heads, cfg.layer_norm_eps, "exp2"),
        lambda: attn_block_pallas._attn_block_plain(x_blk, packed["exp2"], heads, cfg.layer_norm_eps, "exp2"),
        a7_library, a7_ops, a7_ops, io_bytes + 4 * d_model * d_model * 2 + 6 * d_model * 4,
    )
    timing["A8"] = (
        lambda: attn_block_pallas.ffn_block(x_blk, ffn_packed, cfg.layer_norm_eps),
        lambda: attn_block_pallas._ffn_block_plain(x_blk, ffn_packed, cfg.layer_norm_eps, "tanh"),
        a8_library, a8_ops, a8_ops, io_bytes + 2 * d_model * ffn * 2 + (ffn + 3 * d_model) * 4,
    )
    # A11: A7 then A8 in one launch; its yardstick the two composites in turn
    timing["A11"] = (
        lambda: attn_block_pallas.layer_block(x_blk, packed["exp2"], ffn_packed, heads, cfg.layer_norm_eps, "exp2"),
        lambda: attn_block_pallas._layer_block_plain(x_blk, packed["exp2"], ffn_packed, heads, cfg.layer_norm_eps,
                                                     "exp2", "tanh"),
        lambda: a8_library(a7_library()), a7_ops + a8_ops, a7_ops + a8_ops,
        io_bytes + (4 * d_model * d_model + 2 * d_model * ffn) * 2 + (ffn + 9 * d_model) * 4,
    )
    # A12: A7's products in int8 on the int8 tensor cores. No PyTorch call
    # computes int8 attention, so library_ms is null; library_partial_ms is
    # torch._int_mm with the dequantization ((acc sa) sb + bias) for the
    # QKV and W_o products only (a partial figure), on phase 3's operands
    timing["A12"] = (
        lambda: attn_block_pallas.attn_block(x_blk, packed_i8["exp2"], heads, cfg.layer_norm_eps, "exp2", quant="int8"),
        lambda: attn_block_pallas._attn_block_int8_plain(x_blk, packed_i8["exp2"], heads, cfg.layer_norm_eps, "exp2"),
        None, a7_ops, a7_ops, io_bytes + 4 * d_model * d_model + 14 * d_model * 4,
    )

    def int_mm_dequant(a, b_t, sa, sb, bias):
        return torch._int_mm(a, b_t.t()).float() * sa[:, None] * sb + bias

    library_partial = {"A12": lambda: [int_mm_dequant(*args) for args in gemm_i8_args.values()]}
    # A13: A1's function (the same least work), its own algorithm the
    # float32 FFT of 64 chunks a tile of 63 frames (CT_FFT_OPS each) and
    # the scale sums
    a13_tiles = -(-(nc + 1) // lsd_fused._CT_TILE_FRAMES)
    timing["A13"] = (
        lambda: lsd_fused.lsd_wholesig_ct(c, d, HOP, EPS),
        lambda: lsd_fused._lsd_wholesig_ct_plain(c, d, HOP, EPS), None,
        a1_ops, 2 * BATCH * a13_tiles * 64 * lsd_fused.CT_FFT_OPS + 4 * BATCH * t_len, lsd_bytes(t_len),
    )
    # A14: A5's function and yardstick, each variant's kernel and plain version
    for variant, kid in a14_ids.items():
        timing[kid] = (
            lambda v=variant: levinson_pallas.levinson_solve_fused(r0n, bn, variant=v),
            lambda v=variant: levinson_pallas._plain(v)(r0n, bn),
            lambda: torch.linalg.solve(toeplitz_full, bn[..., None]),
            a5_ops, a5_ops, 3 * BATCH * LAGS * 4,
        )
    # A9 at the 16 x 60 s path's shape in its mode there (exp2), A15 at the
    # 820 s pair's: the least work is q k^T and p v (4 T^2 D per row and
    # head) on the bf16 tensor cores; the yardstick is
    # scaled_dot_product_attention on the same q, k, v
    for kid, (q_, k_, v_), kern in (
        ("A9", a9_inputs, lambda q_, k_, v_: sdpa_pallas.sdpa(q_, k_, v_, 0.125, softmax="exp2")),
        ("A15", a15_inputs, lambda q_, k_, v_: sdpa_pallas.flash_sdpa(q_, k_, v_, 0.125)),
    ):
        b_, h_, t_, d_ = q_.shape
        plain = (sdpa_pallas._flash_sdpa_plain if kid == "A15"
                 else lambda q_, k_, v_, s_: sdpa_pallas._sdpa_plain(q_, k_, v_, s_, "exp2"))
        ops = 4 * b_ * h_ * t_ * t_ * d_
        timing[kid] = (
            lambda kern=kern, a=(q_, k_, v_): kern(*a),
            lambda plain=plain, a=(q_, k_, v_): plain(*a, 0.125),
            lambda a=(q_, k_, v_): fn.scaled_dot_product_attention(*a, scale=0.125),
            ops, ops, 4 * b_ * h_ * t_ * d_ * 2,
        )

    # A10 at both variants' shapes on the normalised signals, FFT-level
    # operations as A4; "direct" is the kernel's chunk DFT: 256 chunk rows
    # (127 windows' clean chunks, one before, 128 denoised) per group, each
    # three bf16 (h) x (h, 2h) products; the yardstick is A4's grouped conv1d
    for kid, (cn, dn) in a10_inputs.items():
        n = cn.shape[1]
        kb = -(-n // LAGS)
        groups = -(-kb // sdr_corr_fused.KERNEL_WINDOWS)
        pairs_n = torch.nn.functional.pad(torch.cat([cn, dn], dim=0)[None], (0, LAGS - 1))
        lagged_n = torch.cat([cn, cn], dim=0)[:, None]

        def conv_library(pairs_n=pairs_n, lagged_n=lagged_n):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.nn.functional.conv1d(pairs_n, lagged_n, groups=2 * BATCH)

        timing[kid] = (
            lambda cn=cn, dn=dn: sdr_corr_fused.correlation_lags_fused(cn, dn, LAGS),
            lambda cn=cn, dn=dn: sdr_corr_fused._correlation_lags_fused_plain(cn, dn, LAGS),
            conv_library,
            BATCH * ((2 * kb + 1) * rfft_flops(2 * LAGS) + kb * (LAGS + 1) * (4 + 2 * 8)
                     + 2 * rfft_flops(2 * LAGS)),
            BATCH * groups * 2 * 128 * 3 * 2 * LAGS * 2 * LAGS,
            2 * BATCH * n * 4 + 2 * BATCH * LAGS * 4,
        )

    # A9's and A15's float32 arms on the same inputs in float32: the least
    # work is the TPU's float32 class at "highest", six bf16 products of 4
    # T^2 D per (row, head) on the bf16 tensor cores; "direct" adds exact
    # mode's max pass (six more of 2 T^2 D); the yardstick
    # scaled_dot_product_attention on its memory-efficient backend
    # (float32, no (T, T) logits); then their split pass (bytes: q, k, v
    # read, three bf16 pieces of each written at the padded width)
    def efficient_sdpa(*a):
        with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION):
            return fn.scaled_dot_product_attention(*a, scale=0.125)

    for kid, (q_, k_, v_), kern, plain in (
        ("A9-f32", a9_inputs, lambda *a: sdpa_pallas.sdpa(*a, 0.125, softmax="exact"),
         lambda *a: sdpa_pallas._sdpa_plain(*a, 0.125, "exact")),
        ("A15-f32", a15_inputs, lambda *a: sdpa_pallas.flash_sdpa(*a, 0.125),
         lambda *a: sdpa_pallas._flash_sdpa_plain(*a, 0.125)),
    ):
        b_, h_, t_, d_ = q_.shape
        ops = 6 * 4 * b_ * h_ * t_ * t_ * d_
        direct = ops * 3 // 2 if kid == "A9-f32" else ops
        args = tuple(a.float() for a in (q_, k_, v_))
        timing[kid] = (lambda kern=kern, a=args: kern(*a), lambda plain=plain, a=args: plain(*a),
                       lambda a=args: efficient_sdpa(*a), ops, direct, 4 * b_ * h_ * t_ * d_ * 4)
    args = tuple(a.float() for a in a9_inputs)
    b_, h_, t_, d_ = args[0].shape
    split_bytes = 3 * b_ * h_ * t_ * (d_ * 4 + 3 * sdpa_pallas._head_box(d_) * 2)
    timing["A9-f32-split"] = (lambda a=args: sdpa_pallas.split_pieces(*a),
                              lambda a=args: sdpa_pallas._split_pieces_plain(*a), None, 0, 0, split_bytes)

    # FE: the six convs in a chain from a conv 0 output, as the encoder runs
    # them; the least work is the float32 class on the bf16 tensor cores,
    # six bf16 products of 2 T_out C_out C_in k per row; the yardstick (and
    # the plain version) cuDNN float32 with TF32 off, then F.gelu
    fe_x, fe_w, fe_pieces = fe_inputs(dev)

    def fe_chain(conv):
        y = fe_x
        for w_, p_ in zip(fe_w, fe_pieces):
            y = conv(y, w_, p_)
        return y

    fe_ops = fe_bytes = 0
    t_ = fe_x.shape[2]
    for w_ in fe_w:
        c_out, c_in, k_ = w_.shape
        t_out = (t_ - k_) // 2 + 1
        fe_ops += 6 * 2 * BATCH * t_out * c_out * c_in * k_
        fe_bytes += 4 * BATCH * (c_in * t_ + c_out * t_out)
        t_ = t_out
    fe_plain = lambda: fe_chain(lambda y, w_, p_: conv_gelu._conv_gelu_plain(y, w_, "tanh"))  # noqa: E731
    timing["FE"] = (lambda: fe_chain(lambda y, w_, p_: conv_gelu.conv_gelu(y, w_, "tanh", pieces=p_)),
                    fe_plain, fe_plain, fe_ops, fe_ops, fe_bytes)

    peaks = {"A7": PEAK_BF16_TC_FLOPS, "A8": PEAK_BF16_TC_FLOPS, "A9": PEAK_BF16_TC_FLOPS,
             "A11": PEAK_BF16_TC_FLOPS, "A15": PEAK_BF16_TC_FLOPS, "A12": PEAK_INT8_TC_OPS,
             "A9-f32": PEAK_BF16_TC_FLOPS, "A15-f32": PEAK_BF16_TC_FLOPS, "FE": PEAK_BF16_TC_FLOPS}
    # the kernels' own algorithms on the bf16 tensor cores
    direct_peaks = {"A1": PEAK_BF16_TC_FLOPS, "A2": PEAK_BF16_TC_FLOPS, "A3": PEAK_BF16_TC_FLOPS,
                    "A4": PEAK_BF16_TC_FLOPS, "A4-x3": PEAK_BF16_TC_FLOPS, "A4-x1": PEAK_BF16_TC_FLOPS,
                    "A10": PEAK_BF16_TC_FLOPS, "A10r": PEAK_BF16_TC_FLOPS}
    slow = {"A15": 3, "A15-f32": 3}  # one A15 launch takes ~0.1 s or more: fewer repetitions
    chain_variants = {"A5": "vpu", **{kid: variant for variant, kid in a14_ids.items()}}
    for kid, (kern, plain, library, ops, direct_ops, nbytes) in timing.items():
        r = results[kid]
        peak = peaks.get(kid, PEAK_FP32_FLOPS)
        reps = slow.get(kid, 10)
        r["ms"] = cuda_ms(kern, warmup=min(3, reps), reps=reps)
        r["device_ms"] = cuda_ms(kern, warmup=0, reps=reps, busy=True)
        r["plain_ms"] = cuda_ms(plain, warmup=1, reps=reps)
        r["library_ms"] = None if library is None else cuda_ms(library, warmup=1, reps=reps)
        partial = library_partial.get(kid)
        r["library_partial_ms"] = None if partial is None else cuda_ms(partial, warmup=1, reps=reps)
        r["bound_ms"], r["bound_by"] = bound(ops, nbytes, peak)
        r["direct_bound_ms"], _ = bound(direct_ops, nbytes, direct_peaks.get(kid, peak))
        log(f"{kid} {r['name']}: {r['ms']:.4f} ms, device alone {r['device_ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; {r['direct_bound_ms']:.4f} ms for the kernel's own algorithm), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}"
            + ("" if partial is None else f", library (partial) {r['library_partial_ms']:.4f} ms")
            + ("" if kid not in chain_variants else
               f", chain floor {chain_floor_ms(LAGS, sm_clock_hz, chain_variants[kid]):.4f} ms (an estimate: an "
               f"assumed {FP32_LATENCY_CYCLES} cycles an operation at {sm_clock_hz / 1e9:.2f} GHz; A5's "
               f"{chain_floor_ms(LAGS, sm_clock_hz):.4f} ms)"))

    del fe_x, fe_w, fe_pieces
    # the GEMM of A7 and A8 alone at the layer's four products (M = 64 x 799),
    # against bf16 F.linear on the same operands (its bias in bf16; for W_1
    # followed by F.gelu), beside the least time of 2 M N K operations on
    # the bf16 tensor cores
    xb2 = x_blk.reshape(rows_t, d_model).to(torch.bfloat16)
    hid = attn_block_pallas.gemm(xb2, ffn_packed[0], ffn_packed[1], "gelu_bf16")
    for name, a_, w_, b_, epi in (("QKV", xb2, *packed["exp2"][:2], "bf16"), ("W_o", xb2, *packed["exp2"][2:4], "f32"),
                                  ("W_1", xb2, *ffn_packed[:2], "gelu_bf16"), ("W_2", hid, *ffn_packed[2:4], "f32")):
        w_t, b16 = w_.t().contiguous(), b_.to(torch.bfloat16)
        if epi == "gelu_bf16":
            lib_ms = cuda_ms(lambda: fn.gelu(fn.linear(a_, w_t, b16), approximate="tanh"))
        else:
            lib_ms = cuda_ms(lambda: fn.linear(a_, w_t, b16))
        m_, k_ = a_.shape
        log(f"GEMM {name} ({m_} x {w_.shape[1]} x {k_}, {epi}): "
            f"{cuda_ms(lambda: attn_block_pallas.gemm(a_, w_, b_, epi)):.4f} ms (bound "
            f"{2 * m_ * w_.shape[1] * k_ / PEAK_BF16_TC_FLOPS * 1e3:.4f} ms); F.linear bf16 {lib_ms:.4f} ms")
    del xb2, hid
    # A12's int8 GEMM alone at QKV and W_o (phase 3's operands) against
    # torch._int_mm and the same dequantization, beside the least time of
    # 2 M N K operations on the int8 tensor cores
    for name, args in gemm_i8_args.items():
        (m_, k_), n_ = args[0].shape, args[1].shape[0]
        log(f"int8 GEMM {name} ({m_} x {n_} x {k_}): "
            f"{cuda_ms(lambda: attn_block_pallas.gemm_i8(*args)):.4f} ms (bound "
            f"{2 * m_ * n_ * k_ / PEAK_INT8_TC_OPS * 1e3:.4f} ms); torch._int_mm + dequantization "
            f"{cuda_ms(lambda: int_mm_dequant(*args)):.4f} ms, torch._int_mm alone "
            f"{cuda_ms(lambda: torch._int_mm(args[0], args[1].t())):.4f} ms")

    audio_s = BATCH * SECONDS
    for name, m in metrics.items():
        ms = host_ms(lambda m=m: m(c, d))
        log(json.dumps({"metric": name, "batch": BATCH, "seconds": SECONDS, "ms": ms,
                        "audio_seconds_per_s": audio_s / (ms / 1e3)}))
    peak_all = max(peak_before, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(lambda: sbs(c, d), warmup=1, reps=3)
    log(json.dumps({"metric": "SpeechBERTScore", "batch": BATCH, "seconds": SECONDS, "ms": ms,
                    "audio_seconds_per_s": audio_s / (ms / 1e3),
                    "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}))
    for impl in ("layer_block", "block_int8"):
        metric = pkg.SpeechBERTScore(params=sbs_params, attention_impl=impl)
        ms = host_ms(lambda m=metric: m(c, d), warmup=1, reps=3)
        log(json.dumps({"metric": "SpeechBERTScore", "attention_impl": impl, "batch": BATCH, "seconds": SECONDS,
                        "ms": ms, "audio_seconds_per_s": audio_s / (ms / 1e3)}))
        del metric
    c60, d60 =torch.from_numpy(c60_np).to(dev), torch.from_numpy(d60_np).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(lambda: sbs(c60, d60), warmup=1, reps=3)
    log(json.dumps({"metric": "SpeechBERTScore", "batch": LONG_BATCH, "seconds": LONG_SECONDS, "ms": ms,
                    "audio_seconds_per_s": LONG_BATCH * LONG_SECONDS / (ms / 1e3),
                    "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}))
    exact820 = pkg.SpeechBERTScore(params=sbs_params, precision="highest")
    ms = host_ms(lambda: exact820(c820_np, d820_np), warmup=1, reps=3)
    log(json.dumps({"metric": "SpeechBERTScore", "precision": "highest", "batch": 1, "seconds": FLASH_SECONDS,
                    "ms": ms, "audio_seconds_per_s": FLASH_SECONDS / (ms / 1e3)}))
    del exact820
    for impl in ("fused", "gram", "gram_x1"):
        metric = sdr_fused if impl == "fused" else pkg.SDR(corr_impl=impl)
        ms = host_ms(lambda m=metric: m(c, d))
        log(json.dumps({"metric": "SDR", "corr_impl": impl, "batch": BATCH, "seconds": SECONDS, "ms": ms,
                        "audio_seconds_per_s": audio_s / (ms / 1e3)}))
    conv0_times(sbs, smi, c)
    phase("times: PESQ, DNSMOS")
    for name, opts, metric, clean_in, reps in (
        ("PESQ", {}, pesq_m, c, 10), ("DNSMOS", {}, dnsmos_m, None, 3),
        ("DNSMOS", {"conv_dtype": "bfloat16"}, dnsmos_bf16, None, 3), ("PESQ", {"time_align": True}, pesq_al, c, 10),
    ):
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda m=metric, ci=clean_in: m(ci, d), warmup=1, reps=reps)
        log(json.dumps({"metric": name, **opts, "batch": BATCH, "seconds": SECONDS, "ms": ms,
                        "audio_seconds_per_s": audio_s / (ms / 1e3),
                        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}))
    phase("times: PESQ, DNSMOS done")
    log(f"peak device memory: {peak_all / 2**30:.2f} GiB up to the end-to-end times")

    # -- 6. the bench harness, 7. the mesh ------------------------------------------
    single = {"LSD": metrics["LSD"], "SDR": metrics["SDR"], "STOI": metrics["STOI"], "PESQ": pesq_m,
              "DNSMOS": dnsmos_m, "SpeechBERTScore": sbs}
    bench_harness_phase(results, single, clean_np, noisy_np)
    mesh_phase(pkg, results, single, sbs_params, clean_np, noisy_np)

    # -- 8. result ---------------------------------------------------------------
    phase("result")
    keys = ("name", "id", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "direct_bound_ms",
            "library_ms", "library_partial_ms")
    log(json.dumps({"kernels": [{k: results[kid][k] for k in keys} for kid in sorted(results)]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
