"""PyTorch port, API parity: every public top-level name of a JAX module has
a counterpart in the port's module of the same path.

Both packages are parsed with ``ast`` and neither is imported. A public name
is a function, class or assigned name at a module's top level that does not
start with an underscore. The allowlist holds the names that live elsewhere
in the port, and those that have no counterpart by design.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "fast_speech_enhancement_metrics_tpu"
PORT_PKG = REPO / "fast_speech_enhancement_metrics_tpu_torch"

NO_JIT = "no JIT; the port's own peak"
MEASURED_NEGATIVE = "measured negative on TPU and H100"
#: module -> {name: port module that holds it instead, or the reason it has none}
ALLOWED = {
    "benchmarking/runner.py": {"configure_cache": NO_JIT, "V5E_PEAK_TFLOPS": NO_JIT},
    "models/hubert.py": {"convert_hf_hubert": "utils/convert_hubert.py", "FE_CONV0_PACK": MEASURED_NEGATIVE},
    "ops/attn_block_pallas.py": {"LOG2E": "ops/numerics.py"},
}

JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _top_level_names(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def test_the_jax_package_has_its_modules():
    assert len(JAX_MODULES) > 30 and "ops/stft.py" in JAX_MODULES
    assert set(ALLOWED) <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = PORT_PKG / module
    assert port.exists(), f"the port has no {module}"
    public = {n for n in _top_level_names(JAX_PKG / module) if not n.startswith("_")}
    allowed = ALLOWED.get(module, {})
    assert set(allowed) <= public, f"stale allowlist entries for {module}: {sorted(set(allowed) - public)}"
    missing = sorted(public - _top_level_names(port) - set(allowed))
    assert not missing, f"{module}: no counterpart in the port for {missing}"
    for name, where in allowed.items():
        if where not in (NO_JIT, MEASURED_NEGATIVE):
            assert name in _top_level_names(PORT_PKG / where), f"{name} is not in the port's {where}"
            assert name not in _top_level_names(port), f"{name} is in the port's {module} too"
