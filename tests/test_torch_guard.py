"""The port stands alone: no file of mlease_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package."""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mlease_tpu\b(?!_torch)"
    r"|from\s+mlease_tpu\.|from\s+mlease_tpu\s+import)", re.MULTILINE)


def port_files():
    yield os.path.join(REPO, "chip_smoke.py")
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


def test_guard_pattern_catches_each_form():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "import mlease_tpu", "from mlease_tpu.ops import x",
                 "from mlease_tpu import cli", "    import jax"):
        assert FORBIDDEN.search(line), line
    for line in ("import mlease_tpu_torch", "from mlease_tpu_torch.ops import x",
                 "import jaxtyping"):
        assert not FORBIDDEN.search(line), line
