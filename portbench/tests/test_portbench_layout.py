"""BENCHMARK.json and the files it names: everything is found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert harness.system_of(c.config).SCORE_KEYS
    assert traffic.call_lengths(c.traffic)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_every_config_is_used_and_has_a_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert config["compare"]["limit"] > 0


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]).read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_and_pairs_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_per_layer_keys():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_every_cell_reports_a_per_layer_metric_of_each_layer_it_names():
    for cell in CELLS:
        per = [m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
        assert {m["layer"] for m in per} >= {"entry", "model", "device"}
