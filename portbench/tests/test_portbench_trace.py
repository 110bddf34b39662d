"""The trace reduction and the per-layer readers on a hand-made trace."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.peaks import PEAKS, least_seconds
from portbench.trace import CALL_RANGE, Trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _events():
    """Two calls on the host: 0-100 and 100-200 us. The first launches a
    copy and a model kernel (inside ``model``) and a kernel of ``attn_block``;
    the second a copy and a kernel outside any range."""
    return [
        _x("user_annotation", CALL_RANGE, 0, 100),
        _x("user_annotation", CALL_RANGE, 100, 100),
        _x("user_annotation", "model", 10, 60),
        _x("user_annotation", "attn_block", 40, 20),
        _x("cpu_op", "aten::copy_", 1, 4),
        _x("cpu_op", "aten::to", 80, 15),
        _x("cuda_runtime", "cudaMemcpyAsync", 2, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 101, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 1, correlation=5),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3, 7, correlation=1),
        _x("kernel", "conv_kernel", 22, 30, correlation=2),
        _x("kernel", "flash_kernel", 52, 8, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 102, 8, correlation=4),
        _x("kernel", "other_kernel", 115, 45, correlation=5),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 2, "id": 1},
    ]


def _run(trace: Trace) -> harness.Run:
    cell = harness.load_cell("sbs.eval64x16s")
    records = [harness.CallRecord(0, 0.0, 0.0001, [], None, 1024.0, 64)] * 2
    run = harness.Run(cell, torch.device("cuda"), PEAKS["NVIDIA H100 80GB HBM3"],
                      1.0, records, 2.0, 2.0 * 989e12 * 0.05, 1 << 30, trace=trace, traced=records, evals=2)
    run.shapes = {"attn_block": [(2, 10, 768)]}
    return run


def test_spans_busy_and_gaps():
    t = Trace.from_chrome(_events())
    assert t.calls() == [(0.0, 100.0), (100.0, 200.0)] and t.stretch_us() == 200.0
    assert t.busy_intervals() == [(3.0, 10.0), (22.0, 60.0), (102.0, 110.0), (115.0, 160.0)]
    assert [o.name for o in t.ops_under("model")] == ["conv_kernel", "flash_kernel"]
    assert [o.name for o in t.ops_under("attn_block")] == ["flash_kernel"]
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::to", pytest.approx(40e-6)]  # 60-100: the host in aten::to at 80
    assert gaps[1] == ["portbench.call", pytest.approx(40e-6)]  # 160-200, the second call's end
    assert ["portbench.call", pytest.approx(2e-6)] in gaps  # 100-102: gaps stop at a call's edge
    assert t.top_ops()[0] == ["other_kernel", pytest.approx(45e-6)]


def test_readers_on_the_trace():
    run = _run(Trace.from_chrome(_events()))

    def read(name):
        return harness.reader(name).read(run)

    assert read("copy_ms") == pytest.approx((7 + 8) * 1e-3 / 2)
    assert read("launches_per_call") == 1.5
    assert read("model_ms") == pytest.approx(38e-3 / 2)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 98 / 200))
    assert read("evals_per_call") == 1.0
    assert read("mfu") == pytest.approx(5.0)
    a7 = harness.reader("attn_block_roofline").a7((2, 10, 768), 768)
    assert read("attn_block_roofline") == pytest.approx(100 * least_seconds(*a7, run.peaks) / 8e-6)
    assert read("audio_s_per_s") == 1024.0
    assert read("peak_mem_gib") == 1.0


def test_readers_find_nothing_without_a_trace_or_a_known_card():
    run = _run(None)
    run.peaks = None
    for name in ("copy_ms", "launches_per_call", "model_ms", "device_idle_pct", "mfu", "attn_block_roofline"):
        assert harness.reader(name).read(run) is None


def test_a_failed_call_counts_as_longest():
    run = _run(None)
    ok = harness.CallRecord(0, 0.0, 0.010, [], None, 1.0, 1)
    bad = harness.CallRecord(0, 0.0, 0.001, None, "boom", 1.0, 1)
    run.window = [ok] * 39 + [bad]
    assert harness.reader("call_ms_p95").read(run) == pytest.approx(10.0)
    run.window = [ok] * 38 + [bad] * 2
    assert harness.reader("call_ms_p95").read(run) is None
    assert harness.reader("audio_s_per_s").read(run) == pytest.approx(38 / 2.0)
