"""The port stands alone: no file of mlease_tpu_torch/, not chip_smoke.py
and no tools/torch_*.py script imports JAX or the JAX package, and the
port's native codec is its own library, built under mlease_tpu_torch/."""

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
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
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


def test_the_naive_fit_and_solver_mode_modules_are_guarded():
    """The naive trainer, the partition ids, the re-exporting subpackages
    and the modules that hold the solver modes are among the files the
    guard reads and import cleanly with no CUDA toolchain."""
    import importlib

    rel = {os.path.relpath(p, REPO) for p in port_files()}
    for mod in ("train/naive", "core/partition_ids", "train/admm",
                "train/streaming", "train/pipeline", "ops/tron_multi",
                "ops/objective", "cli", *(f"{sub}/__init__" for sub in (
                    "core", "eval", "io", "ops", "train", "utils"))):
        assert f"mlease_tpu_torch/{mod}.py" in rel, mod
        importlib.import_module("mlease_tpu_torch." + mod.replace(
            "/__init__", "").replace("/", "."))


def test_guard_pattern_catches_each_form():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "import mlease_tpu", "from mlease_tpu.ops import x",
                 "from mlease_tpu import cli", "    import jax"):
        assert FORBIDDEN.search(line), line
    for line in ("import mlease_tpu_torch", "from mlease_tpu_torch.ops import x",
                 "import jaxtyping"):
        assert not FORBIDDEN.search(line), line


def test_the_scale_slice_modules_are_guarded():
    """The native ingest, pack cache, streaming and profiling modules are
    read by the guard and import cleanly; the codec's C++ sources are the
    port's own, and its library lies under mlease_tpu_torch/, never the JAX
    package's native/libmlease_native.so."""
    import importlib

    from mlease_tpu_torch.io import _native_build

    rel = {os.path.relpath(p, REPO) for p in port_files()}
    for mod in ("io/_native_build", "io/fast_decode", "io/fast_encode",
                "io/pack_cache", "core/ingest", "train/streaming",
                "utils/profiling", "train/pipeline"):
        assert f"mlease_tpu_torch/{mod}.py" in rel, mod
        importlib.import_module("mlease_tpu_torch." + mod.replace("/", "."))
    for src in _native_build.SOURCES:
        assert os.path.relpath(src, REPO) in rel
    lib = os.path.realpath(_native_build.library_path())
    assert lib.startswith(os.path.join(REPO, "mlease_tpu_torch") + os.sep)
    for path in port_files():
        with open(path) as f:
            assert "libmlease_native.so" not in f.read(), path


def test_the_mesh_slice_modules_are_guarded():
    """The mesh (parallel/, collectives), the feature sharding and the
    feature-sharded trainer are read by the guard, import cleanly with no
    CUDA toolchain, and no module of the port raises NotImplementedError
    for the mesh. The ops layer reaches the collectives without the mesh's
    data layout."""
    import importlib
    import subprocess
    import sys

    rel = {os.path.relpath(p, REPO) for p in port_files()}
    for mod in ("collectives", "parallel/__init__", "parallel/mesh",
                "parallel/distributed",
                "core/feature_shard", "train/feature_sharded",
                "train/admm", "train/streaming", "train/item",
                "train/naive", "train/pipeline", "ops/tron_multi", "cli"):
        assert f"mlease_tpu_torch/{mod}.py" in rel, mod
        importlib.import_module("mlease_tpu_torch." + mod.replace(
            "/__init__", "").replace("/", "."))
    for path in port_files():
        with open(path) as f:
            text = f.read()
        assert "item A8" not in text and '"A8"' not in text, path
    loaded = subprocess.run(
        [sys.executable, "-c", "import sys, mlease_tpu_torch.ops.tron_multi;"
         " print('mlease_tpu_torch.parallel.mesh' in sys.modules)"],
        capture_output=True, text=True, check=True, cwd=REPO).stdout
    assert loaded.strip() == "False"


def test_the_fused_loop_and_floor_modules_are_guarded():
    """run_fused's device loop (its Python side and csrc/device_loop.cu),
    the floor accounting and the per-pass microbenchmark are read by the
    guard, and the modules import cleanly with no CUDA toolchain."""
    import importlib

    rel = {os.path.relpath(p, REPO) for p in port_files()}
    for mod in ("ops/device_loop", "utils/floor", "ops/tron_multi",
                "train/admm", "train/pipeline"):
        assert f"mlease_tpu_torch/{mod}.py" in rel, mod
        importlib.import_module("mlease_tpu_torch." + mod.replace("/", "."))
    assert "mlease_tpu_torch/csrc/device_loop.cu" in rel
    assert "tools/torch_pass_microbench.py" in rel
