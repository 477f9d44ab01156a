"""Sorted-stream segment sum: the port of the TPU kernel `tile_segment_sum`.

`segment_sum_sorted(contrib (L, T), seg (T,) int32 non-decreasing, S)`
returns the (L, S) per-segment sums. The solver's sparse tail reduces run
through it at three sites (ops/tron_multi.py): the row-sorted Xv tail
(segments = the B*R rows), the column-sorted X'v tail (segments = the B*n
columns) and the fused gradient + Jacobi-diagonal X'v tail over 2L lanes.

On a CUDA tensor it launches the hand-written kernel in
`mlease_tpu_torch/csrc/segment_sum.cu` (which replaces
mlease_tpu/ops/pallas/tile_sum.py::tile_segment_sum; the source says why the
TPU kernel's padded-slab layout was dropped) or raises. On a CPU tensor it
runs the plain version, `segment_sum_sorted_reference`. There is no
fallback from the card to the plain version.

Bound: bandwidth. One call must read L*T contributions and T int32 ids and
write L*S sums: (L*T + L*S) * itemsize + 4*T bytes, over the card's memory
rate (3.35 TB/s on an H100 SXM); see `min_bytes`.

The kernel is built at first use with nvcc (sm_90a, plain C interface) into
`mlease_tpu_torch/_build/`, keyed by a hash of the source, and loaded with
ctypes (ops/_build.py). Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mlease_tpu_torch.ops import _build

SOURCE = _build.CSRC / "segment_sum.cu"

_FN_NAMES = {torch.float32: "segment_sum_sorted_f32",
             torch.float64: "segment_sum_sorted_f64"}
_fns: dict = {}


def build(verbose: bool = False) -> Path:
    """Compile the kernel if its hashed library is missing; return its path
    (see ops/_build.py)."""
    return _build.build(SOURCE, verbose)


def _load() -> dict:
    """{dtype: C entry point}, building and loading the library once."""
    if not _fns:
        lib = _build.load(SOURCE)
        for dtype, name in _FN_NAMES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
    return _fns


def segment_sum_sorted_reference(contrib: torch.Tensor, seg: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Plain version: zero-filled (L, S) plus one index_add_ along the
    stream. Sortedness is not needed here, but the kernel relies on it."""
    out = torch.zeros((contrib.shape[0], num_segments), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(1, seg, contrib)


def segment_sum_sorted(contrib: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """(L, T) contributions reduced into (L, num_segments) sums over a
    non-decreasing int32 segment-id stream. CPU tensors take the plain
    version; CUDA tensors launch the kernel (launches counted in
    `segment_sum_sorted.launches`). The order is not checked here (the
    solver's `stack_blocks` checks it once): an unsorted stream gives wrong
    sums, and the kernel drops ids outside [0, num_segments) rather than
    write out of bounds."""
    if contrib.dim() != 2 or seg.dim() != 1 or seg.shape[0] != contrib.shape[1]:
        raise ValueError(f"expected contrib (L, T) and seg (T,); got "
                         f"{tuple(contrib.shape)} and {tuple(seg.shape)}")
    if seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32; got {seg.dtype}")
    if contrib.device != seg.device:
        raise ValueError("contrib and seg must be on one device")
    if contrib.device.type == "cpu":
        return segment_sum_sorted_reference(contrib, seg, num_segments)
    if contrib.device.type != "cuda":
        raise ValueError(f"unsupported device {contrib.device}")
    if contrib.dtype not in _FN_NAMES:
        raise TypeError(f"the kernel takes float32 or float64; got "
                        f"{contrib.dtype}")
    dev = contrib.device
    if not _build.check_current_device(contrib):
        with torch.cuda.device(dev):     # the launch goes to the current card
            return segment_sum_sorted(contrib, seg, num_segments)
    contrib = contrib.contiguous()
    seg = seg.contiguous()
    L, T = contrib.shape
    out = torch.zeros((L, num_segments), dtype=contrib.dtype, device=dev)
    if L == 0 or T == 0 or num_segments == 0:
        return out
    fn = _load()[contrib.dtype]
    err = fn(contrib.data_ptr(), seg.data_ptr(), out.data_ptr(),
             L, T, num_segments, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_sorted launch failed: CUDA error "
                           f"{err}")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


def min_bytes(L: int, T: int, S: int, itemsize: int) -> int:
    """Bytes one call must move: each input read once, the output written
    once (the bandwidth bound's numerator)."""
    return (L * T + L * S) * itemsize + 4 * T
