"""The readers of the program's own spans and count on a hand-made trace."""

from __future__ import annotations

import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import tracing
from portbench import harness
from portbench.peaks import PEAKS
from portbench.trace import CALL_RANGE, Trace

#: reader -> the span whose launches it times
DEVICE_SPANS = {
    "conv_encoder_ms": "fsem.hubert.conv_encoder",
    "pos_conv_ms": "fsem.hubert.pos_conv",
    "encoder_layers_ms": "fsem.hubert.layer",
    "dnsmos_features_ms": "fsem.dnsmos.features",
    "dnsmos_trunk_ms": "fsem.dnsmos.trunk",
    "dnsmos_edges_ms": "fsem.dnsmos.edges",
}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _events(span: str | None):
    """Two calls on the host, 0-100 and 100-200 us, each with an entry span
    (10 and 14 us); the first launches a kernel inside ``span`` (twice, as
    a layer span repeats) and one outside it, the second one inside."""
    events = [
        _x("user_annotation", CALL_RANGE, 0, 100),
        _x("user_annotation", CALL_RANGE, 100, 100),
        _x("user_annotation", "fsem.entry", 1, 10),
        _x("user_annotation", "fsem.entry", 101, 14),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 130, 1, correlation=4),
        _x("kernel", "a", 32, 10, correlation=1),
        _x("kernel", "b", 52, 20, correlation=2),
        _x("kernel", "outside", 82, 5, correlation=3),
        _x("kernel", "c", 132, 6, correlation=4),
    ]
    if span is not None:
        events += [_x("user_annotation", span, 20, 20), _x("user_annotation", span, 45, 10),
                   _x("user_annotation", span, 120, 30)]
    return events


def _run(trace: Trace | None) -> harness.Run:
    cell = harness.load_cell("sbs.eval64x16s")
    records = [harness.CallRecord(0, 0.0, 0.0001, [], None, 1024.0, 64)] * 2
    return harness.Run(cell, torch.device("cuda"), PEAKS["NVIDIA H100 80GB HBM3"],
                       1.0, records, 2.0, 1.0, 1 << 30, trace=trace, traced=records, evals=2)


@pytest.mark.parametrize("name", list(DEVICE_SPANS))
def test_device_time_under_the_span(name):
    read = harness.reader(name).read
    assert read(_run(Trace.from_chrome(_events(DEVICE_SPANS[name])))) == pytest.approx((10 + 20 + 6) * 1e-3 / 2)
    other = next(s for s in DEVICE_SPANS.values() if s != DEVICE_SPANS[name])
    assert read(_run(Trace.from_chrome(_events(other)))) is None
    assert read(_run(None)) is None


def test_entry_ms():
    read = harness.reader("entry_ms").read
    assert read(_run(Trace.from_chrome(_events(None)))) == pytest.approx((10 + 14) * 1e-3 / 2)
    no_entry = [e for e in _events(None) if e["name"] != "fsem.entry"]
    assert read(_run(Trace.from_chrome(no_entry))) is None
    assert read(_run(None)) is None


@pytest.fixture
def counts(monkeypatch):
    monkeypatch.setattr(tracing, "counts", type(tracing.counts)())
    return tracing.counts


def test_h2d_mib_per_call(counts):
    read = harness.reader("h2d_mib_per_call").read
    run = _run(Trace.from_chrome(_events(None)))
    assert read(run) is None
    counts["h2d_bytes"] = 2 * 2 * 64 * 256_000 * 4  # two calls of two 64 x 16 s arrays
    assert read(run) == 125.0
    assert read(_run(None)) is None
