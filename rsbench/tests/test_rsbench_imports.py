"""Nothing the benchmark runs imports JAX, the JAX package ``repro`` or
``benchmarks/``; the reference imports nothing of the program either.
Top-level module names are compared whole: ``repro_torch`` is not
``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "rsbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _sources():
    return sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)


def test_loaded_modules_by_whole_top_level_name():
    """What importing the harness and the reference loads, in a fresh
    process: the reference alone loads no ``repro_torch``; neither loads
    JAX or ``repro``."""
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; import {mod}; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    for mod, also_forbidden in (("rsbench.reference.judge", {"repro_torch"}),
                                ("rsbench.harness", set())):
        out = subprocess.run([sys.executable, "-c", code.format(
            root=str(ROOT), src=str(ROOT / "src"), mod=mod)], capture_output=True, text=True,
            timeout=120, check=True, env=dict(os.environ))
        loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
        assert not loaded & (FORBIDDEN | also_forbidden), mod
