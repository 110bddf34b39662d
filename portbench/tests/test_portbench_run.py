"""The command's refusals and the import checks (top-level names compared whole)."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"
PORT = "fast_speech_enhancement_metrics_tpu_torch"
JAX_NAMES = {"jax", "jaxlib", "flax", "fast_speech_enhancement_metrics_tpu"}


def _run(args, cwd=ROOT, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def _imports(path: Path) -> set[str]:
    """Top-level names of the modules a source imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("cell", ["sbs.eval64x16s", "dnsmos.eval64x16s"])
def test_workload_fails_without_a_card(cell):
    r = _run(["-m", "portbench.run", "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    assert r.returncode == 2
    assert "{" not in r.stdout
    assert "needs 1 CUDA card" in r.stderr


def test_run_fails_in_a_checkout_of_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("_runs", "__pycache__"))
    r = _run(["-m", "portbench.run", "--workload", "sbs.eval64x16s", "--seed", "1", "--seconds", "1"], cwd=tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & JAX_NAMES, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        assert PORT not in _imports(path), path
    r = _run(["-c", "import sys, portbench.reference.hubert, portbench.reference.dnsmos; "
                    "print(sorted({m.split('.')[0] for m in sys.modules}))"])
    loaded = set(json.loads(r.stdout.replace("'", '"')))
    assert r.returncode == 0 and PORT not in loaded and not loaded & JAX_NAMES


def test_a_run_loads_no_jax():
    """A whole run, set-up to the check, in a fresh process: no module
    whose top-level name is JAX's or the JAX package's, compared whole (the
    port's name begins with the JAX package's)."""
    code = ("import sys; sys.path.insert(0, 'portbench/tests'); import portbench_tiny; "
            "r = portbench_tiny.run_tiny('sbs.ragged'); from portbench import harness; "
            "print(r['correct'], harness.forbidden_modules(), "
            f"'{PORT}' in {{m.split('.')[0] for m in sys.modules}})")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-3:] == ["True", "[]", "True"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    monkeypatch.setitem(sys.modules, f"{PORT}_fake.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fast_speech_enhancement_metrics_tpu.metrics", sys)
    assert harness.forbidden_modules() == ["fast_speech_enhancement_metrics_tpu"]
