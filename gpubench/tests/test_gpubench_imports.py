"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference and the data generator import nothing of the port."""

from __future__ import annotations

import ast
import glob
import os

import pytest

from conftest import ROOT

FILES = sorted(glob.glob(os.path.join(ROOT, "gpubench", "**", "*.py"),
                         recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "mlease_tpu"}


def top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, ROOT) for f in FILES])
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "datagen.py",
                                  "roofline.py", "stats.py"])
def test_yardstick_imports_nothing_of_the_port(name):
    found = top_level_imports(os.path.join(ROOT, "gpubench", name))
    assert "mlease_tpu_torch" not in found
    assert found <= {"__future__", "dataclasses", "math", "warnings",
                     "torch", "numpy", "gpubench"}


def test_guard_compares_whole_names():
    assert "mlease_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "mlease_tpu.ops".split(".")[0] in FORBIDDEN
