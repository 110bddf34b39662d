"""PyTorch port, tracing: the spans and the host-to-device count of
``tracing.py``, which do nothing unless a ``torch.profiler`` session records.

On the CPU: no profiler range and no count without a profiler; under one,
each span of SpeechBERTScore (a small config) and DNSMOS (a short clip) at
its place, none in the profiler's warm-up step, one per ragged length group,
and the scores bit for bit those of an unprofiled call. The card case (marked
``cuda``, skips here) reads the host-to-device bytes; on a machine with a
card run it as

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py

This file imports no JAX, so it runs without tests/conftest.py.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from fast_speech_enhancement_metrics_tpu_torch import DNSMOS, LSD, SpeechBERTScore, tracing
from fast_speech_enhancement_metrics_tpu_torch.metrics import dnsmos as dnsmos_mod
from fast_speech_enhancement_metrics_tpu_torch.metrics import speechbertscore as sbs_mod
from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "fast_speech_enhancement_metrics_tpu_torch"

#: the SMALL config of tests/test_torch_speechbertscore.py (which imports JAX)
SMALL = dict(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=256,
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)
LAYERS = 2
#: the span names the program opens, as tracing.py lists them
SPANS = {
    "fsem.entry", "fsem.exit", "fsem.ragged_group",
    "fsem.hubert.conv_encoder", "fsem.hubert.pos_conv", "fsem.hubert.layer",
    "fsem.dnsmos.features", "fsem.dnsmos.trunk", "fsem.dnsmos.edges",
}


def _audio(rows, samples, seed=0):
    rs = np.random.RandomState(seed)
    clean = (0.1 * rs.randn(rows, samples)).astype(np.float32)
    return clean, (clean + 0.05 * rs.randn(rows, samples)).astype(np.float32)


@pytest.fixture(scope="module")
def sbs():
    """Batch 2, output_layer 2, the doubled batch in two row chunks."""
    cfg = hubert.HubertConfig(**SMALL)
    params = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    metric = SpeechBERTScore(device="cpu", params=params, config=cfg, output_layer=LAYERS, batch_chunk=2)
    return metric, _audio(2, 8000)


@pytest.fixture(scope="module")
def short_clip():
    return _audio(1, 16000, seed=1)


def _profiled(call, marks=()):
    """``call()`` in each step of a CPU profiler session of one warm-up and
    two active steps, each function of ``marks`` ((module, attribute,
    range name)) wrapped in a range of its own: the three results and the
    recorded ranges (name, start, end) in order of start."""
    originals = [(module, attr, getattr(module, attr)) for module, attr, _ in marks]
    for (module, attr, original), (_, _, name) in zip(originals, marks):
        def wrapped(*args, _original=original, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _original(*args, **kwargs)

        setattr(module, attr, wrapped)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)
    results = []
    try:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU], schedule=schedule) as prof:
            for _ in range(3):
                results.append(call())
                prof.step()
    finally:
        for module, attr, original in originals:
            setattr(module, attr, original)
    names = SPANS | {name for _, _, name in marks}
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name in names),
                    key=lambda r: r[1])
    return results, ranges


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_no_range_and_no_count(sbs, short_clip, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = dict(tracing.counts)
    metric, (clean, denoised) = sbs
    metric(clean, denoised)
    DNSMOS(device="cpu")(None, short_clip[1])
    LSD(device="cpu")([clean[0], denoised[0][:7000]], [denoised[0], clean[0][:7000]])
    assert opened == [] and dict(tracing.counts) == before
    _profiled(lambda: metric(clean, denoised))
    assert {n for n in opened if n.startswith("fsem.")} == {
        "fsem.entry", "fsem.exit", "fsem.hubert.conv_encoder", "fsem.hubert.pos_conv", "fsem.hubert.layer"}


def test_speechbertscore_spans(sbs):
    metric, (clean, denoised) = sbs
    want = metric(clean, denoised)
    results, ranges = _profiled(lambda: metric(clean, denoised),
                                [(sbs_mod, "hubert_hidden_state", "test.model")])
    assert results == [want] * 3  # bit for bit, in the warm-up step and the active ones
    chunk = ["test.model", "fsem.hubert.conv_encoder", "fsem.hubert.pos_conv"] + ["fsem.hubert.layer"] * LAYERS
    # two active steps (none in the warm-up one), two row chunks a call, one span per layer per chunk
    assert [r[0] for r in ranges] == (["fsem.entry"] + chunk * 2 + ["fsem.exit"]) * 2
    models = [r for r in ranges if r[0] == "test.model"]
    for r in ranges:
        if r[0].startswith("fsem.hubert."):
            assert any(_inside(r, m) for m in models)
        elif r[0] in ("fsem.entry", "fsem.exit"):
            assert not any(_inside(m, r) for m in models)


@pytest.mark.parametrize("plan", ["shared_exact", "per_window"])
def test_dnsmos_spans(short_clip, plan):
    metric = DNSMOS(device="cpu", window_plan=plan)
    clean, denoised = short_clip
    want = metric(clean, denoised)
    net = ("dnsmos_net_windowed_exact", ["fsem.dnsmos.features", "fsem.dnsmos.trunk", "fsem.dnsmos.edges"]) \
        if plan == "shared_exact" else ("dnsmos_net", ["fsem.dnsmos.features", "fsem.dnsmos.trunk"])
    results, ranges = _profiled(lambda: metric(clean, denoised), [(dnsmos_mod, net[0], "test.net")])
    assert results == [want] * 3
    assert [r[0] for r in ranges] == (["fsem.entry", "test.net"] + net[1] + ["fsem.exit"]) * 2
    nets = [r for r in ranges if r[0] == "test.net"]
    for r in ranges:
        if r[0].startswith("fsem.dnsmos."):
            assert any(_inside(r, n) for n in nets)


def test_one_span_per_ragged_group_and_no_count_on_the_cpu():
    clean, denoised = _audio(3, 9000, seed=2)
    lengths = (9000, 7000, 9000)
    c = [clean[i, :n] for i, n in enumerate(lengths)]
    d = [denoised[i, :n] for i, n in enumerate(lengths)]
    metric = LSD(device="cpu")
    before = tracing.counts["h2d_bytes"]
    results, ranges = _profiled(lambda: metric(c, d))
    assert results[0] == results[1] == results[2] and len(results[0]) == 3
    groups = [r for r in ranges if r[0] == "fsem.ragged_group"]
    assert len(groups) == 2 * 2  # two length groups in each of the two active steps
    for r in ranges:
        if r[0] in ("fsem.entry", "fsem.exit"):
            assert any(_inside(r, g) for g in groups)
    assert tracing.counts["h2d_bytes"] == before


def test_span_names_are_the_programs_own():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        opened |= set(re.findall(r'tracing\.span\("([^"]+)"\)', path.read_text()))
    assert opened == SPANS
    taken = {"portbench.call", "portbench.eval"}
    for path in (ROOT / "portbench" / "configs").glob("*.json"):
        taken |= set(json.loads(path.read_text()).get("trace_ranges", {}))
    assert "model" in taken and all(n.startswith("fsem.") for n in opened) and not opened & taken


def test_launch_counts_is_one_counter():
    assert cuda_lib.launch_counts is tracing.launch_counts


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_h2d_bytes_on_the_card(dev):
    metric = DNSMOS(device=dev)
    clean, denoised = _audio(2, 16000, seed=3)
    before = tracing.counts["h2d_bytes"]
    _profiled(lambda: metric(clean, denoised))
    assert tracing.counts["h2d_bytes"] - before == 2 * (2 * 2 * 16000 * 4)  # two active steps, both arrays
    on_card = torch.from_numpy(clean).to(dev), torch.from_numpy(denoised).to(dev)
    before = tracing.counts["h2d_bytes"]
    _profiled(lambda: metric(*on_card))
    assert tracing.counts["h2d_bytes"] == before
