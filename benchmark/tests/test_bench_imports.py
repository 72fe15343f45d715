"""What the benchmark's modules import: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the plain reference."""
import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "alfalfa_tpu"}


def _modules(top):
    for root, _, files in os.walk(top):
        if "tests" in os.path.relpath(root, harness.BENCH).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules(harness.BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(harness.BENCH, "reference"))))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "alfalfa_tpu_torch" not in set(_imports(path)), path


def test_the_whole_top_level_name_is_compared(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "alfalfa_tpu_torch_probe", types.ModuleType("p"))
    monkeypatch.delitem(sys.modules, "alfalfa_tpu", raising=False)
    assert "alfalfa_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("j"))
    assert "jax" in harness.forbidden_modules()
