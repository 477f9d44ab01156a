"""The port stands alone: no file of mlease_tpu_torch/, not chip_smoke.py
and no tools/torch_*.py script imports JAX or the JAX package."""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mlease_tpu\b(?!_torch)"
    r"|from\s+mlease_tpu\.|from\s+mlease_tpu\s+import)", re.MULTILINE)


def port_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for f in sorted(os.listdir(os.path.join(REPO, "tools"))):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(REPO, "tools", f)
    for dirpath, _dirs, files in os.walk(os.path.join(REPO,
                                                      "mlease_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = list(port_files())
    assert len(files) > 20 and os.path.exists(files[0])
    offenders = []
    for path in files:
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_the_item_slice_modules_are_guarded():
    """Every module of the per-item slice is among the files the guard
    reads, and each imports cleanly on a host with no CUDA toolchain."""
    import importlib

    rel = {os.path.relpath(p, REPO) for p in port_files()}
    for mod in ("ops/_build", "ops/gram", "ops/objective", "ops/tron",
                "ops/newton", "ops/tron_multi", "train/item",
                "eval/item_score", "convert", "cli"):
        assert f"mlease_tpu_torch/{mod}.py" in rel, mod
        importlib.import_module("mlease_tpu_torch." + mod.replace("/", "."))
    assert "mlease_tpu_torch/csrc/gram.cu" in rel


def test_guard_pattern_catches_each_form():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "import mlease_tpu", "from mlease_tpu.ops import x",
                 "from mlease_tpu import cli", "    import jax"):
        assert FORBIDDEN.search(line), line
    for line in ("import mlease_tpu_torch", "from mlease_tpu_torch.ops import x",
                 "import jaxtyping"):
        assert not FORBIDDEN.search(line), line
