"""The port stands alone: no file under src/repro_torch/, nor chip_smoke.py,
imports jax or the JAX package `repro` (it keeps its own copies)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


# the control plane, the throughput study and the grounded lifecycle
CONTROL_PLANE = [f"src/repro_torch/serving/{m}.py" for m in (
    "router", "prefill", "autoscaler", "lifecycle", "migration",
    "simulator", "resources")] + ["src/repro_torch/launch/grounded_churn.py"]


def test_port_has_files():
    assert len(PORT_FILES) > 20
    assert all(p.exists() for p in PORT_FILES)
    assert {ROOT / f for f in CONTROL_PLANE} <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import os\nfrom repro.kernels import ref\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert set(_imported_roots(f)) & set(FORBIDDEN) == {"repro", "jax"}
