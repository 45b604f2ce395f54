"""No module under ``nerfbench/`` imports JAX, flax or the JAX package,
compared by the whole top-level name of each import (``nerfacc_tpu_torch``
only begins with ``nerfacc_tpu``); the reference imports nothing of the
program either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "nerfacc_tpu"}
PROGRAM = "nerfacc_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_the_rule_tells_the_two_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import nerfacc_tpu_torch.grid\nfrom nerfacc_tpu_torch import pdf\n")
    assert top_level_imports(src) == {PROGRAM}
    src.write_text("from nerfacc_tpu.grid import x\n")
    assert top_level_imports(src) & NEVER == {"nerfacc_tpu"}


def test_a_run_process_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from nerfbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "nerfacc_tpu_torch_fake", types.ModuleType("nerfacc_tpu_torch_fake"))
    assert "nerfacc_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "nerfacc_tpu.grid", types.ModuleType("nerfacc_tpu.grid"))
    assert "nerfacc_tpu" in forbidden_modules()
