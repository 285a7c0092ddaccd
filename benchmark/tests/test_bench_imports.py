"""Nothing the benchmark runs imports JAX or the JAX package, compared on
whole top-level module names (detectron_tpu_torch starts with
detectron_tpu), and the reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
STDLIB_OR_TORCH = {"contextlib", "math", "numpy", "torch"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    assert not imported(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_torch_and_numpy(path):
    assert imported(path) <= STDLIB_OR_TORCH


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("detectron_tpu_torch", "detectron_tpu_torch.core",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jax", "jaxlib", "flax", "detectron_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "detectron_tpu.utils", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["detectron_tpu", "jaxlib"]
