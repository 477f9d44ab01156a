"""Build and load the port's CUDA kernels: nvcc by hand, ctypes to bind.

Every kernel source under `mlease_tpu_torch/csrc/` has a plain C interface
(pointers and the stream as void*, each entry returning cudaGetLastError()
of its launch). `build_many` compiles sources for sm_90a into
`mlease_tpu_torch/_build/`, one nvcc process per source, all started
together; a library is keyed by a hash of its source and of the headers
(`csrc/*.cuh`) beside it, so an unchanged source is never rebuilt. `load` builds at first use and returns the ctypes library.
Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit's nvcc")


def library_path(source: Path) -> Path:
    sha = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        sha.update(header.read_bytes())
    digest = sha.hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_many(sources: Sequence[Path], verbose: bool = False) -> list[Path]:
    """Compile every source whose hashed library is missing, in parallel;
    return the libraries' paths in the order of `sources`. verbose=True adds
    -Xptxas -v (registers, shared memory, spills) and prints the compiler's
    output."""
    outs = [library_path(s) for s in sources]
    procs = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for source, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) on "
                            f"{source.name}:\n{stderr}")
            continue
        if verbose:
            print(f"nvcc {source.name}\n{stdout}{stderr}", flush=True)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build(source: Path, verbose: bool = False) -> Path:
    return build_many([source], verbose)[0]


def load(source: Path) -> ctypes.CDLL:
    """The ctypes library of one source, built and loaded once."""
    lib = _libs.get(source)
    if lib is None:
        lib = _libs[source] = ctypes.CDLL(str(build(source)))
    return lib


def check_current_device(t) -> bool:
    """True when a CUDA tensor lies on the current card (a launch goes to
    the current card's stream)."""
    import torch
    return t.device.index is None or \
        t.device.index == torch.cuda.current_device()
