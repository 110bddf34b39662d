"""One cell of the benchmark, end to end: set-up, the timed window, the
profiled stretch, the metrics and the check against the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* a configuration is ``configs/<name>.json`` (its ``system`` names the
  module under ``systems/`` that makes its weights, builds the program's
  metric, counts its FLOPs and runs its reference);
* a traffic mix is ``traffic/<name>.json``, read by ``traffic.py``;
* a metric, end-to-end or per-layer, is ``readers/<name>.py``, whose
  ``read(run)`` returns the value or None when it finds nothing to read.

Besides the answers, the check compares an intermediate of the timed path
where the configuration names one (``capture``): a row of the named
function's output in each of the window's first calls, against the
reference's same intermediate of the benchmark's own row of audio.

The window drives the program's public call, ``metric(clean, denoised)``,
on host float32 arrays in a closed loop with one caller, cycling the
traffic's pool of calls in the seed's order, until ``seconds`` have passed;
the call running then finishes, and the window ends with it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import traffic as traffic_mod
from portbench.peaks import peaks_for
from portbench.trace import CALL_RANGE, EVAL_RANGE, Trace
from portbench.traffic import derived_seed

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
RUNS_DIR = BENCH_DIR / "_runs"
#: top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fast_speech_enhancement_metrics_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the metrics a --trace 0 run reports
    per_layer: list[dict]  # the metrics a --trace 1 run reports


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise ValueError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = _named(bench["workloads"], name, "workload")
    return make_cell(bench, name, wl["config"], wl["traffic"], wl["chips"], root)


def make_cell(bench: dict, name: str, config: str, traffic: str, chips: int = 1, root: Path = ROOT) -> Cell:
    """A cell of ``bench``'s configuration and traffic mix of these names,
    with the metrics ``bench`` gives a cell called ``name``."""
    with open(root / _named(bench["configs"], config, "configuration")["file"]) as f:
        config_data = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{traffic}.json") as f:
        traffic_data = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, chips, config_data, traffic_data, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def system_of(config: dict):
    return importlib.import_module(f"portbench.systems.{config['system']}")


def reader(metric_name: str):
    path = BENCH_DIR / "readers" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_reader_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """The forbidden top-level module names ``sys.modules`` holds, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit_w(device: torch.device) -> float | None:
    """The card's power limit (nvidia-smi), which a share of a peak assumes
    at its full 700 W; None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class CallRecord:
    index: int  # the call's place in the pool
    start: float  # host clock, seconds
    end: float
    scores: list | None  # what the public call returned
    error: str | None  # what it raised
    audio_s: float
    pairs: int

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


@dataclasses.dataclass
class Run:
    """What a reader reads."""

    cell: Cell
    device: torch.device
    peaks: dict | None  # the card's, from peaks.py; None off the card
    setup_s: float
    window: list[CallRecord]
    window_s: float
    window_flops: float  # least FLOPs of the window's answered calls
    peak_bytes: int | None
    trace: Trace | None = None
    traced: list[CallRecord] = dataclasses.field(default_factory=list)
    evals: int = 0  # batched evaluations in the traced calls
    shapes: dict = dataclasses.field(default_factory=dict)  # range -> first argument's shape, per entry


def one_call(metric, pool: traffic_mod.Pool, index: int, mark: bool = False) -> CallRecord:
    call = pool.calls[index]
    ctx = torch.profiler.record_function(CALL_RANGE) if mark else contextlib.nullcontext()
    start = time.perf_counter()
    try:
        with ctx:
            scores, error = metric(call.clean, call.denoised), None
    except Exception:  # a call that raises is a miss, counted and judged
        scores, error = None, traceback.format_exc(limit=4)
    end = time.perf_counter()
    return CallRecord(index, start, end, scores, error, call.audio_s, len(call.lengths))


class Capture:
    """Rows of an intermediate of the timed path, kept on the device for the
    check: while ``active`` holds the window position of a call, each call
    of the configuration's ``capture`` target keeps one row of its output,
    drawn from the seed, with the row of audio (argument ``input_arg``) it
    came from. ``calls``: the window's first calls that are captured."""

    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.rng = random.Random(derived_seed(seed, "capture"))
        self.active: int | None = None
        self.rows: list[tuple[int, torch.Tensor, torch.Tensor]] = []  # (position, audio row, output row)

    def wants(self, position: int) -> bool:
        return position < self.spec["calls"]

    @contextlib.contextmanager
    def installed(self):
        module_name, attr = self.spec["target"].split(":")
        module = importlib.import_module(module_name)
        original = getattr(module, attr)

        def wrapped(*args, **kwargs):
            out = original(*args, **kwargs)
            if self.active is not None:
                audio = args[self.spec["input_arg"]]
                j = self.rng.randrange(audio.shape[0])
                self.rows.append((self.active, audio[j].float().clone(), out[j].float().clone()))
            return out

        setattr(module, attr, wrapped)
        try:
            yield
        finally:
            setattr(module, attr, original)


def window(metric, pool: traffic_mod.Pool, seconds: float,
           capture: Capture | None = None) -> tuple[list[CallRecord], float]:
    """Calls in the pool's order until ``seconds`` have passed: the records
    and the window's length, to the end of its last call."""
    records, t0, i = [], time.perf_counter(), 0
    while True:
        if capture is not None:
            capture.active = i if capture.wants(i) else None
        records.append(one_call(metric, pool, pool.order[i % len(pool.order)]))
        i += 1
        if records[-1].end - t0 >= seconds:
            if capture is not None:
                capture.active = None
            return records, records[-1].end - t0


@contextlib.contextmanager
def instrumented(metric, config: dict, run: Run):
    """Ranges around each batched evaluation (counted) and around the
    program's functions that the configuration names, each entry's first
    argument's shape recorded; all taken off again on exit."""
    restore = []
    for range_name, target in config.get("trace_ranges", {}).items():
        module_name, attr = target.split(":")
        module = importlib.import_module(module_name)
        original = getattr(module, attr)

        def wrapped(*args, _original=original, _name=range_name, **kwargs):
            run.shapes.setdefault(_name, []).append(tuple(args[0].shape) if args and hasattr(args[0], "shape") else None)
            with torch.profiler.record_function(_name):
                return _original(*args, **kwargs)

        setattr(module, attr, wrapped)
        restore.append((module, attr, original))
    evaluate = metric._run_prepared

    def counted(*args, **kwargs):
        run.evals += 1
        with torch.profiler.record_function(EVAL_RANGE):
            return evaluate(*args, **kwargs)

    metric._run_prepared = counted
    try:
        yield
    finally:
        del metric._run_prepared
        for module, attr, original in restore:
            setattr(module, attr, original)


def profiled(metric, pool: traffic_mod.Pool, run: Run, start: int) -> None:
    """The traffic's ``trace_calls`` calls under the profiler, after one
    call that warms it, with the benchmark's ranges in place."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    n = run.cell.traffic["trace_calls"]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
    with instrumented(metric, run.cell.config, run), torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        for i in range(n + 1):
            if i == 1:  # the warm-up step's counts are not the stretch's
                run.evals, run.shapes = 0, {}
            record = one_call(metric, pool, pool.order[(start + i) % len(pool.order)], mark=True)
            if i:
                run.traced.append(record)
            sync(run.device)
            prof.step()
    run.trace = Trace.from_profiler(prof, RUNS_DIR / f"{run.cell.name}.trace.json")


def judge(cell: Cell, reference, pool: traffic_mod.Pool, records: list[CallRecord]) -> tuple[bool, dict]:
    """Every answer of every timed call against the plain reference: the
    widest gap over the configuration's score keys, the calls that raised,
    and the answers missing, misshapen or not finite."""
    expected: dict[int, list] = {}
    gap, failed, bad = 0.0, 0, 0
    for r in records:
        if r.error is not None:
            failed += 1
            continue
        if r.index not in expected:
            call = pool.calls[r.index]
            expected[r.index] = reference.scores(call.clean, call.denoised)
        want = expected[r.index]
        if not isinstance(r.scores, list) or len(r.scores) != len(want):
            bad += len(want)
            continue
        for got, ref in zip(r.scores, want):
            for key in reference.keys:
                value = got.get(key) if isinstance(got, dict) else None
                diff = abs(value - ref[key]) if isinstance(value, float) else math.nan
                if math.isfinite(diff):
                    gap = max(gap, diff)
                else:
                    bad += 1
    compare = cell.config["compare"]
    compared = {
        compare["name"]: {"value": gap, "limit": compare["limit"]},
        "calls_failed": {"value": failed, "limit": 0},
        "answers_bad": {"value": bad, "limit": 0},
    }
    correct = bool(records) and gap <= compare["limit"] and failed == 0 and bad == 0
    return correct, compared


def _source_row(call: traffic_mod.Call, row: torch.Tensor) -> torch.Tensor | None:
    """The row of the call's audio (clean or denoised) that ``row`` holds:
    the nearest of its length, if within a bf16 rounding of it (exact where
    the program keeps the audio in float32)."""
    best, best_diff = None, math.inf
    for a in (*call.clean, *call.denoised):
        if a.shape[-1] != row.shape[0]:
            continue
        t = torch.from_numpy(a).to(row.device)
        diff = float((row - t).abs().max() / t.abs().max().clamp_min(1e-30))
        if diff < best_diff:
            best, best_diff = t, diff
    return best if best_diff <= 2.0**-8 else None


def judge_capture(reference, pool: traffic_mod.Pool, records: list[CallRecord],
                  capture: Capture) -> tuple[bool, dict]:
    """Each captured row against the reference's same intermediate of the
    benchmark's own audio row: the widest gap, as a share of the largest
    magnitude of the reference's row; rows whose audio is not the call's,
    and no row at all, count as unmatched."""
    spec = capture.spec
    gap, unmatched = 0.0, 0 if capture.rows else 1
    with torch.inference_mode():
        for position, audio_row, out_row in capture.rows:
            source = _source_row(pool.calls[records[position].index], audio_row)
            if source is None:
                unmatched += 1
                continue
            want = reference.captured(source)
            diff = float((out_row - want).abs().max() / want.abs().max()) if out_row.shape == want.shape else math.nan
            if math.isfinite(diff):
                gap = max(gap, diff)
            else:
                unmatched += 1
    compared = {spec["name"]: {"value": gap, "limit": spec["limit"]},
                f"{spec['name']}_unmatched": {"value": unmatched, "limit": 0}}
    return gap <= spec["limit"] and unmatched == 0, compared


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float | None = None, variant: str | None = None) -> dict:
    """One run of ``cell``: the result line's fields. ``t0``: the host
    clock at process start, from which ``setup_s`` counts; ``variant``:
    the name of one of the configuration's ``controls``, a step down in
    precision, builds the program with its keywords."""
    t0 = time.perf_counter() if t0 is None else t0
    system = system_of(cell.config)
    weights = system.make_weights(cell.config, seed, device)
    pool = traffic_mod.make_pool(cell.traffic, seed, device)
    metric = system.build_metric(cell.config, weights, device, variant)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for i in pool.warmup_indices():
        metric(pool.calls[i].clean, pool.calls[i].denoised)
    sync(device)
    setup_s = time.perf_counter() - t0

    on_card = device.type == "cuda"
    capture = Capture(cell.config["capture"], seed) if "capture" in cell.config else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    with capture.installed() if capture is not None else contextlib.nullcontext():
        records, window_s = window(metric, pool, seconds, capture)
    sync(device)
    RUNS_DIR.mkdir(exist_ok=True)
    with open(RUNS_DIR / f"{cell.name}.calls.json", "w") as f:  # the window's calls, for a look at its course
        json.dump([[r.index, r.start - records[0].start, r.ms, r.error is None] for r in records], f)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    name = torch.cuda.get_device_name(device) if on_card else None
    answered = [r for r in records if r.error is None]
    run = Run(cell, device, peaks_for(name), setup_s, records, window_s,
              sum(system.call_flops(cell.config, pool.calls[r.index].lengths) for r in answered), peak)
    if trace:
        profiled(metric, pool, run, len(records))

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else device.type, "kind": name or str(device),
                   "count": 1, "memory_peak_bytes": peak}
    if trace and on_card:
        device_info["power_limit_w"] = power_limit_w(device)
    if trace and run.trace is not None and run.trace.calls():
        device_info["busy_s"] = sum(b - a for a, b in run.trace.busy_intervals()) * 1e-6
        device_info["window_s"] = run.trace.stretch_us() * 1e-6

    del metric
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = system.Reference(cell.config, weights, device)
    all_records = records + run.traced
    correct, compared = judge(cell, reference, pool, all_records)
    if capture is not None:
        captured_ok, captured = judge_capture(reference, pool, records, capture)
        correct, compared = correct and captured_ok, {**compared, **captured}
    result = {
        "correct": correct,
        "attempted": sum(r.pairs for r in all_records),
        "failed": sum(r.pairs for r in all_records if r.error is not None),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    errors = [r.error for r in all_records if r.error is not None]
    if errors:
        print(f"{len(errors)} calls raised; the first:\n{errors[0]}", file=sys.stderr)
    result["compared"] = compared
    return result
