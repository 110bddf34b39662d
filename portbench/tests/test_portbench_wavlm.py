"""The WavLM configuration (sbs-wavlm-large) on the CPU: its weights, a short
cell against the reference, the planted fault, and a clean failure on a
program without the relative-position bias."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench import harness
from portbench.systems import speechbertscore as sbs
from portbench.systems import speechbertscore_wavlm as wavlm

SEED = 2**31 + 11


def _cell(seconds: float = 1.0) -> harness.Cell:
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = harness.make_cell(bench, "sbs-wavlm.eval64x16s", "sbs-wavlm-large", "eval64x16s")
    cell.traffic.update(pool_calls=2, trace_calls=1, pairs_per_call=2)
    cell.traffic["lengths"]["seconds"] = seconds
    return cell


def test_weights_carry_the_gate_and_the_table():
    cell = _cell()
    tree = wavlm.make_weights(cell.config, SEED, torch.device("cpu"))
    model = cell.config["model"]
    assert len(tree["layers"]) == cell.config["output_layer"] == 14
    assert tree["rel_embed"].shape == (model["num_buckets"], model["num_attention_heads"])
    assert tree["layers"][0]["gate_w"].shape == (64, 8) and tree["layers"][13]["gate_const"].shape == (16,)
    assert "norm_scale" in tree["feature_encoder"][6] and "bn_scale" not in tree["pos_conv"]
    assert 0.8 < tree["rel_embed"].std() < 1.2 and 0.1 < tree["layers"][0]["gate_w"].std() < 0.15
    assert wavlm.call_flops(cell.config, (16000,)) > sbs.call_flops(cell.config, (16000,))


def test_short_cell_is_correct_and_the_planted_fault_moves_f1():
    torch.set_num_threads(4)
    cell = _cell()
    program = harness.run_cell(cell, SEED, 0.01, True, torch.device("cpu"))
    assert program["correct"], program["compared"]
    assert program["metrics"]["relpos_bias_mib_per_call"]["value"] > 0  # the plain route builds the bias
    fault = harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"), variant="no_relpos")
    assert fault["compared"]["f1_gap"]["value"] > 100 * max(program["compared"]["f1_gap"]["value"], 1e-7)


def test_a_program_without_the_bias_fails_at_once(monkeypatch):
    from fast_speech_enhancement_metrics_tpu_torch.models import hubert

    fields = {f.name: f.default for f in dataclasses.fields(hubert.HubertConfig) if f.name != "relative_position_bias"}
    monkeypatch.setattr(hubert, "HubertConfig", dataclasses.make_dataclass("HubertConfig", list(fields)))
    with pytest.raises(RuntimeError, match="relative_position_bias"):
        wavlm.make_weights(_cell().config, SEED, torch.device("cpu"))


def test_the_hidden_state_capture_sees_the_residual_stream_in_bf16():
    """On the kernel route's plain versions (``relpos_block`` on the CPU,
    the card's rounding points), the planted control that keeps only the
    layers' residual stream in bf16 moves the captured hidden state well
    past the program's own gap, where F1 hardly moves."""
    torch.set_num_threads(4)
    cell = _cell()
    cell.config["metric_kwargs"] = {"attention_impl": "relpos_block"}
    program = harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"))
    fault = harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"), variant="residual_bf16")
    gaps = [r["compared"]["hidden_gap"]["value"] for r in (program, fault)]
    assert program["compared"]["hidden_gap_unmatched"]["value"] == 0 and 0 < gaps[0], program["compared"]
    assert gaps[1] > 1.5 * gaps[0], gaps
    print(program["compared"], fault["compared"])
