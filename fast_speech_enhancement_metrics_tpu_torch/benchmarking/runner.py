"""Benchmark core: metric factories and on-device timing on the card.

Counterpart of the JAX package's ``benchmarking/runner.py``, with its
protocol (reference: benchmark_metrics.py:49-84): inputs already on the
device, warm-up excluded, every timed region ends in a device->host copy
of the scores, which cannot complete before the computation has.

Two numbers per metric:

* ``audio_seconds_per_s`` (headline) — device throughput. The JAX package
  runs K evaluations as one ``lax.scan`` program and fetches the (K, B)
  scores once. Here one evaluation is captured into a CUDA graph
  (``_Scan``) and replayed K times without a host sync, then the (K, B)
  scores are fetched once. Each evaluation reads the audio plus an offset
  ``eps`` computed on the device from the previous evaluation's scores
  (loop-carried: nothing is hoistable and the K evaluations serialize), and
  each dispatch starts from a fresh seed. On a CPU device the same
  recurrence runs as an eager loop.
* ``per_call_ms`` — one blocking call from the host (``_run_prepared``
  plus the score fetch), launches and host time included.

A metric that runs a host-orchestrated plan (``host_chunk``) is timed per
call, as in the JAX package; a graph capture that fails on any other metric
raises. A calibration canary of known operations runs through the same
protocol and must stay below the card's peak, or the suite refuses to
report.

The JAX package's ``configure_cache`` (a persistent XLA compilation cache)
has no counterpart: there is no JIT here, and the CUDA kernels build once
per source into the package's ``_build/`` directory.
"""

from __future__ import annotations

import collections
import os
import subprocess
import time

import numpy as np
import torch

from fast_speech_enhancement_metrics_tpu_torch.base import _resolve_device
from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib

#: the upstream reference's "ours GPU" throughput at batch 64 in
#: audio-seconds/s (samples/s read off its plots/samples_per_second.png x
#: 16 s clips): its published numbers on an unspecified GPU
#: (BASELINE.md:16-37), not numbers taken on this card
REFERENCE_GPU_AUDIO_S = {
    "PESQ": 6_400.0,
    "STOI": 21_600.0,
    "SDR": 104_000.0,
    "LSD": 208_000.0,
    "DNSMOS": 4_160.0,
    "SpeechBERTScore": 2_720.0,
}

#: published dense bf16 tensor-core peak of one H100 SXM (TFLOP/s, NVIDIA's
#: data sheet, at the 700 W limit); a canary above it means the timing is
#: not synchronizing and the results are invalid
H100_PEAK_BF16_TFLOPS = 989.0

#: evaluations per dispatch in the graph (device-throughput) protocol
SCAN_K = 32
#: adaptive deepening: fast metrics replay more evaluations per dispatch so
#: that the dispatch and fetch amortize
SCAN_K_MAX = 256
#: per-dispatch duration target when deepening (seconds)
SCAN_TARGET_S = 2.5


def make_metrics(sample_rate: int = 16000, device=None) -> dict:
    """Factories for all six metrics, benchmark-configured as in the JAX
    package, on ``device`` (default: the card)."""
    from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, PESQ, SDR, STOI, SpeechBERTScore

    def make_sbs():
        from fast_speech_enhancement_metrics_tpu_torch.metrics.speechbertscore import DEFAULT_CHECKPOINT

        # act_dtype=bf16: the activation stream in bf16, as the JAX bench runs it
        if DEFAULT_CHECKPOINT.exists():
            return SpeechBERTScore(act_dtype=torch.bfloat16, device=device)
        # no converted mHuBERT-147 weights: random weights of the same
        # architecture (the same operations and memory traffic)
        from fast_speech_enhancement_metrics_tpu_torch.models.hubert import MHUBERT_147_CONFIG, init_params

        return SpeechBERTScore(params=init_params(torch.Generator().manual_seed(0), MHUBERT_147_CONFIG),
                               act_dtype=torch.bfloat16, device=device)

    return {
        "PESQ": lambda: PESQ(device=device),
        "STOI": lambda: STOI(sample_rate=sample_rate, device=device),
        "SDR": lambda: SDR(device=device),
        "LSD": lambda: LSD(device=device),
        # the fused shared_exact plan with the bf16 trunk, as the JAX bench
        "DNSMOS": lambda: DNSMOS(conv_dtype=torch.bfloat16, device=device),
        "SpeechBERTScore": make_sbs,
    }


def device_info(device: torch.device) -> dict:
    """The device a record was taken on: the card's name and power limit
    (``nvidia-smi``), or ``"cpu"``."""
    if device.type != "cuda":
        return {"device": str(device)}
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit}


def calibration_canary(device=None, n: int = 4096, chain_len: int = 100) -> dict:
    """A chain of ``chain_len`` dependent n^2 bf16 products timed like a
    metric call (the host fetch of one element ends it), and the same kind
    of work through the graph protocol. Implied TFLOP/s above the card's
    bf16 peak mean the fetch does not synchronize and every number from
    this process is void. Also the cost of a no-op round trip
    (``fetch_overhead_ms``)."""
    dev = _resolve_device(device)
    a = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    b = torch.ones((n, n), dtype=torch.bfloat16, device=dev)

    def chain():
        x = a
        for _ in range(chain_len):
            x = (x @ b) * (1.0 / n)  # dependent chain, magnitude-stable
        return x[:1, :1].float().cpu()

    chain()  # warm
    t0 = time.perf_counter()
    out = chain()
    elapsed = time.perf_counter() - t0
    tflops = 2 * n**3 * chain_len / elapsed / 1e12

    tiny = out.to(dev)
    (tiny + 1.0).cpu()
    t0 = time.perf_counter()
    for _ in range(10):
        (tiny + 1.0).cpu()
    overhead_ms = (time.perf_counter() - t0) / 10 * 1e3

    scan_tflops = _scanned_protocol_canary(dev)
    return {
        "canary_tflops": round(float(tflops), 1),
        "canary_scan_tflops": round(float(scan_tflops), 1),
        "canary_ok": bool(
            tflops <= 1.1 * H100_PEAK_BF16_TFLOPS and scan_tflops <= 1.1 * H100_PEAK_BF16_TFLOPS
        ),
        "canary_checksum": float(out[0, 0]),
        "fetch_overhead_ms": round(float(overhead_ms), 3),
    }


def _scanned_protocol_canary(device: torch.device, batch: int = 8, n: int = 1024, chain: int = 8) -> float:
    """Known operations through the graph protocol (``_Scan``) at the
    deepest dispatch the suite may use (``SCAN_K_MAX``): audio-shaped input,
    a chain of bf16 products, (B,) scores. Implied TFLOP/s above the card's
    peak mean replays were skipped or not synchronized."""
    noisy = torch.from_numpy(
        np.random.default_rng(7).standard_normal((batch, n * n // batch)).astype(np.float32)
    ).to(device)

    def compute(_, sig):
        x = sig.reshape(n, n).to(torch.bfloat16)
        y = x
        for _ in range(chain):
            y = (y @ x) * (1.0 / n)
        return {"canary": torch.mean(y.float().reshape(batch, -1), dim=1)}

    runner = _Scan(compute, False, None, noisy)
    runner(0, SCAN_K_MAX).cpu()  # warm
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        out = runner(1 + i, SCAN_K_MAX).cpu()
    elapsed = time.perf_counter() - t0
    assert out.shape == (1, SCAN_K_MAX, batch)
    return reps * SCAN_K_MAX * chain * 2 * n**3 / elapsed / 1e12


class _Scan:
    """K evaluations of ``compute(clean, noisy)`` per dispatch, each on the
    audio plus a 0-d device offset ``eps`` that the previous evaluation's
    scores set: ``eps' = mod(|sum of scores|, 977) 1e-12 + 1e-12`` (the JAX
    package's ``_scanned``; ~1e-9 of the signal scale, below reporting
    precision, but no two evaluations read the same input and each waits on
    the last).

    On a CUDA device one evaluation, with the ``eps`` update and the copy of
    its scores into a static (keys, B) slot, is captured into a CUDA graph
    over the static inputs; a dispatch replays it K times, copying the slot
    into row k of a (keys, K, B) tensor after each replay, all enqueued
    without a host sync. ``graph_launches``: the package's kernel launches
    counted while capturing, i.e. those of one replay. On a CPU device the
    evaluations run eagerly. ``eps_history``: the offsets the last
    dispatch's evaluations read."""

    def __init__(self, compute, intrusive: bool, clean, noisy):
        self._compute = compute
        self._clean = clean if intrusive else None
        self._noisy = noisy
        self.device = noisy.device
        self.eps = torch.zeros((), dtype=torch.float32, device=self.device)
        self.keys: list[str] = []
        self.graph = None
        self.graph_launches = None
        self.eps_history = None
        if self.device.type == "cuda":
            self._capture()

    def _step(self) -> torch.Tensor:
        """One evaluation; sets ``eps`` for the next. (keys, B) float32 scores."""
        c = None if self._clean is None else self._clean + self.eps
        scores = self._compute(c, self._noisy + self.eps)
        self.keys = list(scores)
        total = sum(torch.sum(v.float()) for v in scores.values())
        self.eps.copy_(torch.remainder(torch.abs(total), 977.0) * 1e-12 + 1e-12)
        return torch.stack([v.float() for v in scores.values()])

    def _capture(self) -> None:
        # warm on a side stream first (cuBLAS / cuDNN plans and workspaces
        # for a stream other than the default one), as PyTorch's capture
        # recipe asks
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = collections.Counter(cuda_lib.launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._slot = self._step()
        self.graph_launches = dict(collections.Counter(cuda_lib.launch_counts) - before)

    def __call__(self, seed: int, scan_k: int) -> torch.Tensor:
        """Enqueue ``scan_k`` evaluations from ``eps = 1e-12 (seed + 1)``;
        (keys, K, B) float32 scores on the device, not yet synchronized."""
        self.eps.fill_(1e-12 * (seed + 1))
        self.eps_history = torch.empty(scan_k, dtype=torch.float32, device=self.device)
        out = None
        for k in range(scan_k):
            self.eps_history[k].copy_(self.eps)
            if self.graph is None:
                scores = self._step()
            else:
                self.graph.replay()
                scores = self._slot
            if out is None:
                out = scores.new_empty((scores.shape[0], scan_k, scores.shape[1]))
            out[:, k].copy_(scores)
        return out


def _make_scanned_runner(name: str, metric, clean, noisy) -> _Scan | None:
    """The graph protocol's runner for ``metric`` on prepared inputs, or
    None for a host-orchestrated plan (``host_chunk``), which is timed per
    call. A capture that fails raises, naming the metric."""
    if getattr(metric, "host_chunk", None) is not None:
        return None
    try:
        return _Scan(metric._compute_resampled, not metric.NON_INTRUSIVE, clean, noisy)
    except RuntimeError as e:
        raise RuntimeError(f"{name}: capturing one evaluation into a CUDA graph failed: {e}") from e


def bench_one(
    name: str,
    metric,
    clean,
    noisy,
    duration_s: float,
    time_budget_s: float = 10.0,
) -> dict:
    """Time one metric on inputs placed on its device first; a record with
    the device throughput (graph protocol, or per call for a host plan),
    the single-call latency, the package's kernel launches of one eager call
    and of the captured graph, and the device's name (and power limit)."""
    batch = noisy.shape[0]
    prepared_clean, prepared_noisy = metric.prepare_inputs(None if metric.NON_INTRUSIVE else clean, noisy)
    device = metric.device

    def run_once():
        # the metric's plan; the device->host copy of the stacked (B,)
        # score vectors is the synchronization point
        scores = metric._run_prepared(prepared_clean, prepared_noisy)
        return torch.stack([v.float() for v in scores.values()]).cpu()

    before = collections.Counter(cuda_lib.launch_counts)
    t0 = time.perf_counter()
    eager = run_once()
    compile_s = time.perf_counter() - t0
    launches = dict(collections.Counter(cuda_lib.launch_counts) - before)

    lat_iters, t0 = 3, time.perf_counter()
    for _ in range(lat_iters):
        run_once()
    per_call_s = (time.perf_counter() - t0) / lat_iters

    scanned = _make_scanned_runner(name, metric, prepared_clean, prepared_noisy)
    if scanned is not None:
        def run_scan(seed, k):
            return scanned(seed, k).cpu()

        run_scan(0, SCAN_K)  # warm the replays
        t0 = time.perf_counter()
        run_scan(1, SCAN_K)
        per_dispatch = max(time.perf_counter() - t0, 1e-4)
        scan_k = SCAN_K
        deep_k = min(SCAN_K_MAX, max(SCAN_K, int(SCAN_TARGET_S / (per_dispatch / SCAN_K))))
        deep_k -= deep_k % SCAN_K
        if deep_k > SCAN_K:
            # a fast metric: the dispatch and fetch are a material share at K = 32
            scan_k = deep_k
            t0 = time.perf_counter()
            run_scan(1, scan_k)
            per_dispatch = max(time.perf_counter() - t0, 1e-4)
        iters = max(2, int(time_budget_s / per_dispatch))
        t0 = time.perf_counter()
        for i in range(iters):
            out = run_scan(2 + i, scan_k)  # a fresh seed: no two dispatches identical
        elapsed = time.perf_counter() - t0
        assert out.shape == (len(scanned.keys), scan_k, batch)
        # the replays compute the call's function: the last dispatch's first
        # evaluation (its offset ~1e-11) against the first eager call
        vs_eager = float(torch.max(torch.abs(out[:, 0] - eager)))
        batches_timed = iters * scan_k
        protocol = "graph" if scanned.graph is not None else "loop"
    else:
        per_call = max(per_call_s, 1e-4)
        iters = max(3, int(time_budget_s / per_call))
        t0 = time.perf_counter()
        for _ in range(iters):
            run_once()
        elapsed = time.perf_counter() - t0
        batches_timed = iters
        protocol = "per_call"
        vs_eager = None

    profile_dir = os.environ.get("FSEM_BENCH_PROFILE")
    if profile_dir:  # a torch.profiler trace of a few steady-state calls
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            for _ in range(3):
                run_once()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))

    throughput = batch * duration_s * batches_timed / elapsed
    record = {
        "metric": name,
        "batch": batch,
        "audio_seconds_per_s": throughput,
        "samples_per_s": throughput / duration_s,
        "per_call_ms": round(per_call_s * 1e3, 3),
        "protocol": protocol,
        "batches_timed": batches_timed,
        "compile_s": round(compile_s, 2),
        "launches": launches,
        "graph_launches": None if scanned is None else scanned.graph_launches,
        "scan_vs_eager_max_abs": vs_eager,
        **device_info(device),
    }
    if name in REFERENCE_GPU_AUDIO_S:
        record["ref_gpu_audio_seconds_per_s"] = REFERENCE_GPU_AUDIO_S[name]
        record["speedup_vs_ref_gpu"] = throughput / REFERENCE_GPU_AUDIO_S[name]
    return record
