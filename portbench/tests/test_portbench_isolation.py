"""The benchmark stands apart from the JAX package: no file under
portbench/ imports jax, jaxlib, flax or the JAX package ``repro`` (whole
top-level names: ``repro_torch`` is the port), and the plain reference
imports nothing of the port either."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
REFERENCE = sorted((HERE / "reference").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            # a relative import inside portbench: its package's root
            yield "portbench"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE.parent)))
def test_no_jax_or_jax_package(path):
    assert not set(imported_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(
    p.relative_to(HERE.parent)))
def test_reference_imports_nothing_of_the_port(path):
    roots = set(imported_roots(path))
    assert not roots & (FORBIDDEN | {"repro_torch"}), roots
    # nor anything of the harness that does
    assert roots <= {"__future__", "math", "typing", "torch"}, roots


def test_scan_reads_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.models\nfrom repro.kernels import ref\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert set(imported_roots(f)) == {"repro_torch", "repro", "jax"}
    assert set(imported_roots(f)) & FORBIDDEN == {"repro", "jax"}


def test_there_are_files():
    assert len(FILES) > 15 and REFERENCE
