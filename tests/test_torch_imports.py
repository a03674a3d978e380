"""The port stands alone: no file of bayesrrcpp_tpu_torch/ imports jax or the
JAX package (whose __init__ imports jax and changes the process-wide
matmul precision)."""
import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "bayesrrcpp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bayesrrcpp_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(PKG.rglob("*.py"))


def test_the_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in _sources()}
    assert {"__init__.py", "ops/jacobi_t.py", "models/bayesr.py",
            "models/horseshoe.py", "utils/summary.py", "utils/profiling.py",
            "tools/gpu_validation.py", "tools/drift_probe.py",
            "tools/ld_validation.py", "tools/comm_model.py",
            "tools/dryrun.py"} <= names
    for src in ("jacobi_t.cu", "jacobi_t_mc.cu", "jacobi_t_common.cuh"):
        assert (PKG / "csrc" / src).exists(), src


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_imports(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
