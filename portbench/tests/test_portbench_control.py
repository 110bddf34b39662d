"""The check that decides ``correct``: sound runs pass; each control (a
step down in the configuration's precision) and planted faults fail. On the CPU at a
small size; the readings that set each limit are taken on the card at the
cell's own size (``python -m portbench.control``)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import portbench_tiny  # noqa: E402

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric  # noqa: E402

CELLS = sorted(portbench_tiny.PAIRS)
#: (cell, control) for every control of the configuration of each eval cell
#: but TF32, which exists only on the card (its readings are taken there)
CONTROLS = [(cell, name) for cell in ("sbs.eval64x16s", "dnsmos.eval64x16s")
            for name, kwargs in json.loads((Path(__file__).resolve().parents[1] / "configs" /
                                            f"{portbench_tiny.PAIRS[cell][0]}.json").read_text())["controls"].items()
            if "tf32" not in kwargs]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_traced_run_is_correct(cell):
    r = portbench_tiny.run_tiny(cell, trace=True)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    assert "breakdown" in r


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_the_control_is_not_correct(cell, control):
    """At 4 pairs of 4 s: the int8 attention block's error grows with the
    frames (at 1 s SpeechBERTScore's int8 control reads near its limit)."""
    r = portbench_tiny.run_tiny(cell, variant=control, pairs=4, seconds=4.0)
    assert not r["correct"], r["compared"]


def test_bf16_activations_fail_on_the_features_alone():
    """SpeechBERTScore's bf16 activations: the captured conv features fail
    their limit whatever F1 reads."""
    r = portbench_tiny.run_tiny("sbs.eval64x16s", variant="act_bf16", pairs=4, seconds=4.0)
    c = r["compared"]
    assert c["features_gap"]["value"] > c["features_gap"]["limit"] and c["features_gap_unmatched"]["value"] == 0


def test_a_sound_run_compares_the_features_of_the_window_first_calls():
    r = portbench_tiny.run_tiny("sbs.eval64x16s", pairs=4, seconds=4.0)
    c = r["compared"]
    assert r["correct"] and 0 < c["features_gap"]["value"] < c["features_gap"]["limit"] / 3, c
    assert c["features_gap_unmatched"]["value"] == 0


def _altered(run_prepared):
    """An answer altered where it is produced: the first score of each
    evaluation moved by 0.05."""

    def fault(self, clean, denoised):
        scores = run_prepared(self, clean, denoised)
        key = next(iter(scores))
        scores[key] = scores[key].clone()
        scores[key][0] += 0.05
        return scores

    return fault


def _half_batch(run_prepared):
    """Half of the batch left out: the first half of the rows scored, the
    others given the mean of those."""

    def fault(self, clean, denoised):
        keep = (denoised.shape[0] + 1) // 2
        scores = run_prepared(self, None if clean is None else clean[:keep], denoised[:keep])
        rest = denoised.shape[0] - keep
        return {k: torch.cat([v, v.mean().expand(rest)]) for k, v in scores.items()}

    return fault


@pytest.mark.parametrize("fault", [_altered, _half_batch], ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("cell", ["sbs.eval64x16s", "dnsmos.eval64x16s"])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(BaseMetric, "_run_prepared", fault(BaseMetric._run_prepared))
    r = portbench_tiny.run_tiny(cell)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell", ["sbs.ragged", "dnsmos.ragged"])
def test_an_altered_answer_in_a_ragged_call_is_not_correct(monkeypatch, cell):
    monkeypatch.setattr(BaseMetric, "_run_prepared", _altered(BaseMetric._run_prepared))
    assert not portbench_tiny.run_tiny(cell)["correct"]


def test_a_call_that_raises_is_not_correct(monkeypatch):
    calls = {"n": 0}
    original = BaseMetric.__call__

    def flaky(self, clean, denoised):
        calls["n"] += 1
        if calls["n"] == 3:  # after the two warm-up calls: the window's first
            raise RuntimeError("planted")
        return original(self, clean, denoised)

    monkeypatch.setattr(BaseMetric, "__call__", flaky)
    r = portbench_tiny.run_tiny("sbs.eval64x16s")
    assert not r["correct"] and r["failed"] == 2 and r["compared"]["calls_failed"]["value"] == 1
