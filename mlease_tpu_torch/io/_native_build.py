"""Build the port's native Avro codec (`mlease_tpu_torch/native/*.cpp`).

The decoder and encoder are compiled together with g++ (the flags of the
JAX package's `native/Makefile`) into one shared library under
`mlease_tpu_torch/_build/`, at first use and never at import. The library's
name carries a hash of both sources, so a changed source is rebuilt and a
stale library is never loaded. Concurrent processes are safe: the build
holds an `fcntl` lock on a file beside the library, compiles to a name of
its own and `os.replace`s the result into place, so no process ever loads a
half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "native" / "avro_decode.cpp",
           _PKG / "native" / "avro_encode.cpp")
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
LDFLAGS = ["-shared", "-lz", "-pthread"]


def compiler() -> str | None:
    """The C++ compiler on PATH (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def library_path() -> Path:
    sha = hashlib.sha1()
    for src in SOURCES:
        sha.update(src.read_bytes())
    return BUILD_DIR / f"libmlease_native-{sha.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled first when it is missing. Raises
    RuntimeError when no compiler is found or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH (g++ or c++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():            # another process built it meanwhile
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXXFLAGS, *map(str, SOURCES), "-o", str(tmp),
                 *LDFLAGS], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"native codec build failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
