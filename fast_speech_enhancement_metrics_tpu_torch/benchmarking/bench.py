"""Throughput benchmark of the port on the card.

Counterpart of the repository's ``bench.py`` (the JAX package's), with the
same protocol, environment knobs and last line: batch 64 x 16 s clips on
the device before timing, warm-up discarded, ``runner.bench_one``'s graph
protocol, audio-seconds per second per card. Run it from the repository
root::

    python -m fast_speech_enhancement_metrics_tpu_torch.benchmarking.bench

It prints ONE JSON line last: the geometric mean of the speedups over the
upstream reference's published GPU numbers (``runner.REFERENCE_GPU_AUDIO_S``).
Per-metric records stream as ``#`` lines and land in
``results/torch/bench_details.json``. Each metric runs in a subprocess of
its own with a timeout and retries (orchestrator mode);
``FSEM_BENCH_METRICS=<name>`` runs the named metrics inline (worker
mode). A worker refuses to report when the calibration canary reads above
1.1 x the card's bf16 peak.

Env knobs:
  FSEM_BENCH_BATCH (default 64)   FSEM_BENCH_DUR (default 16)
  FSEM_BENCH_METRICS (comma list) FSEM_BENCH_SECONDS (time budget per metric)
  FSEM_BENCH_TIMEOUT (subprocess timeout, default 900 s)
  FSEM_BENCH_ATTEMPTS (retries per metric, default 3)
  FSEM_BENCH_BEST_OF (successful attempts per metric, default 3)
  FSEM_BENCH_TOTAL_BUDGET (wall budget after which one success suffices, 1800 s)
  FSEM_BENCH_PROFILE (directory for a torch.profiler trace per metric)
  FSEM_BENCH_MESH=N (the mesh work-division check on N ranks, one per card;
                     with FSEM_BENCH_DEVICE=cpu, N gloo ranks on the CPU)
  FSEM_BENCH_DEVICE ("cuda", the default, or "cpu")
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MODULE = "fast_speech_enhancement_metrics_tpu_torch.benchmarking.bench"
ALL_METRICS = ["PESQ", "STOI", "SDR", "LSD", "DNSMOS", "SpeechBERTScore"]

BATCH = int(os.environ.get("FSEM_BENCH_BATCH", 64))
DURATION_S = int(os.environ.get("FSEM_BENCH_DUR", 16))
SAMPLE_RATE = 16000
TIME_BUDGET_S = float(os.environ.get("FSEM_BENCH_SECONDS", 8))
DEVICE = os.environ.get("FSEM_BENCH_DEVICE", "cuda")
RESULTS_DIR = Path("results/torch")


def run_worker(names: list[str]) -> list[dict]:
    """Benchmark the named metrics inline; print one ``#`` line each."""
    from fast_speech_enhancement_metrics_tpu_torch.benchmarking.runner import (
        bench_one,
        calibration_canary,
        make_metrics,
    )
    from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

    # timing-protocol self check: products whose implied TFLOP/s must stay
    # below the card's peak, else the fetch is not synchronizing and every
    # number from this process would be an enqueue time
    canary = calibration_canary(DEVICE)
    print(f"# {json.dumps({'metric': '_canary', **canary})}", flush=True)

    clean, noisy, _ = load_audio_data(DURATION_S, BATCH, SAMPLE_RATE)
    factories = make_metrics(SAMPLE_RATE, DEVICE)

    details = []
    for name in names:
        metric = None
        try:
            if not canary["canary_ok"]:
                raise RuntimeError(
                    f"timing canary measured {canary['canary_tflops']} / {canary['canary_scan_tflops']} "
                    "TFLOP/s (> the card's peak): synchronization broken, refusing to report"
                )
            metric = factories[name]()
            result = bench_one(name, metric, clean, noisy, DURATION_S, TIME_BUDGET_S)
            result.update(canary)
        except Exception as e:  # keep the suite going; report the failure
            result = {"metric": name, "error": f"{type(e).__name__}: {e}"}
        details.append(result)
        print(f"# {json.dumps(result)}", flush=True)
        del metric  # free device memory before the next metric
    return details


def run_orchestrator(names: list[str]) -> list[dict]:
    """One subprocess per metric with a timeout and retries. Each metric
    runs ``FSEM_BENCH_BEST_OF`` successful attempts (one more when they
    spread by over 15 %) and the fastest is reported; every attempt's
    throughput and scan canary stay in the record (``attempts``)."""
    timeout_s = float(os.environ.get("FSEM_BENCH_TIMEOUT", 900))
    attempts = int(os.environ.get("FSEM_BENCH_ATTEMPTS", 3))
    best_of = int(os.environ.get("FSEM_BENCH_BEST_OF", 3))
    total_budget_s = float(os.environ.get("FSEM_BENCH_TOTAL_BUDGET", 1800))
    t_start = time.time()

    details = []
    for name in names:
        successes: list[dict] = []
        for attempt in range(1, attempts + best_of + 2):
            over_budget = time.time() - t_start > total_budget_s
            if successes and over_budget:
                break
            if len(successes) >= (1 if over_budget else best_of):
                vals = [r["audio_seconds_per_s"] for r in successes]
                if min(vals) > 0.85 * max(vals) or len(successes) >= best_of + 2:
                    break
            env = dict(os.environ, FSEM_BENCH_METRICS=name)
            try:
                proc = subprocess.run([sys.executable, "-m", MODULE], timeout=timeout_s, env=env,
                                      capture_output=True, text=True)
            except subprocess.TimeoutExpired:
                print(f"# {name}: attempt {attempt} timed out after {timeout_s:.0f}s — retrying", flush=True)
                continue
            record = None
            for line in proc.stdout.splitlines():
                if line.startswith("# "):
                    candidate = json.loads(line[2:])
                    if candidate.get("metric") == name:
                        record = candidate
            if record is not None and "error" not in record:
                successes.append(record)
            else:
                why = record["error"] if record is not None else proc.stderr.strip()[-2000:]
                print(f"# {name}: attempt {attempt} produced no result — retrying ({why})", flush=True)
        if not successes:
            record = {"metric": name, "error": f"no result after {attempts} attempts"}
        else:
            record = max(successes, key=lambda r: r["audio_seconds_per_s"])
            record["attempts"] = [
                {"audio_seconds_per_s": r["audio_seconds_per_s"], "canary_scan_tflops": r.get("canary_scan_tflops")}
                for r in successes
            ]
        details.append(record)
        print(f"# {json.dumps(record)}", flush=True)
    return details


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_mode(n_devices: int) -> None:
    """The mesh work-division check (``mesh_check.py``) on ``n_devices``
    ranks: this process launches them as ``torchrun`` would, each rank runs
    the check, and rank 0's verdict is the last line."""
    if "RANK" in os.environ:  # a rank
        import torch.distributed as dist

        from fast_speech_enhancement_metrics_tpu_torch.benchmarking.mesh_check import run_mesh_check
        from fast_speech_enhancement_metrics_tpu_torch.parallel import create_mesh, initialize_distributed

        initialize_distributed(DEVICE)
        try:
            report = run_mesh_check(create_mesh(data=n_devices, device_type=DEVICE))
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            ok = 1 if report["ok"] else 0
            print(json.dumps({"metric": "mesh_work_division_ok", "value": ok, "unit": "bool", "vs_baseline": ok}))
        return

    base = dict(os.environ, WORLD_SIZE=str(n_devices), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    procs = [
        subprocess.Popen([sys.executable, "-m", MODULE], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=float(os.environ.get("FSEM_BENCH_TIMEOUT", 900)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-3000:], file=sys.stderr)
            raise SystemExit(f"mesh rank {rank} exited with {p.returncode}")
    print(outs[0].rstrip(), flush=True)


def main() -> None:
    mesh_n = os.environ.get("FSEM_BENCH_MESH")
    if mesh_n:
        run_mesh_mode(int(mesh_n))
        return
    selected = os.environ.get("FSEM_BENCH_METRICS")
    if selected:
        run_worker(selected.split(","))
        return

    details = run_orchestrator(ALL_METRICS)

    ok = [d for d in details if "error" not in d]
    speedups = [d["speedup_vs_ref_gpu"] for d in ok]
    geomean = float(np.exp(np.mean(np.log(speedups)))) if speedups else 0.0

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    with open(RESULTS_DIR / "bench_details.json", "w") as f:
        json.dump({"batch": BATCH, "duration_s": DURATION_S, "details": details}, f, indent=2)

    print(json.dumps({
        "metric": "suite_geomean_speedup_vs_reference_gpu",
        "value": round(geomean, 3),
        "unit": "x",
        "vs_baseline": round(geomean, 3),
    }))


if __name__ == "__main__":
    main()
