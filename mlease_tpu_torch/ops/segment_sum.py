"""Sorted-stream segment sum with its producer inside: the port of the TPU
kernel `tile_segment_sum`.

`segment_sum_gather(vals, V, idx, seg, S, *, out=None, square_from=L)`
computes, for a non-decreasing int32 segment-id stream `seg` (T,),

    out[l, seg[i]] += w_l(vals[i]) * V[l, idx[i]]    (gather form)
    out[l, seg[i]] += w_l(vals[l, i])                (contrib form: V, idx
                                                      None, vals (L, T))

with w_l(v) = v for l < square_from and v * v from square_from on. `out` is
the caller's (L, S) accumulator, updated in place and returned; without one
a zero-filled (L, S) is allocated. Segments the stream does not touch keep
their bits. The solver's three sorted tail reduces (ops/tron_multi.py) are
one call each: the row-sorted Xv tail (segments = the B*R rows), the
column-sorted X'v tail (segments = the B*n columns) and the gradient +
Jacobi-diagonal X'v tail over 2L lanes (square_from = L), as the JAX
package writes each of them as one fused expression.
`segment_sum_sorted(contrib (L, T), seg, S)` keeps the first version's
contract on top of the contrib form: the (L, S) sums, zero-filled.

Types: float32 and float64 compute in their own type; bfloat16 vals and V
are read as bfloat16, every product (v * v squared from the bfloat16
value), sum and carry is float32, and each touched segment of `out` is
rounded once (its old value widened, the sum added in float32). A bfloat16
call may also take a float32 `out` (the solver's scores, which stay in
float32), added into without a rounding. The ids are int32 in every
type.

On a CUDA tensor both launch the hand-written kernel in
`mlease_tpu_torch/csrc/segment_sum.cu` (which replaces
mlease_tpu/ops/pallas/tile_sum.py::tile_segment_sum; its header gives the
design) or raise. On a CPU tensor they run the plain version,
`segment_sum_gather_reference`. There is no fallback from the card to the
plain version. Every call on the card adds one to
`segment_sum_sorted.launches`, K1's launch count (its carry passes belong
to the call), and, where a device loop captures it, one on the card to
`segment_sum_sorted.device_launches` (ops/device_loop.py). The kernel
uses no float atomics: the same inputs give the same bits in every run.

V is lanes-major (L, m), or a lanes-minor view (the transpose of an (m, L)
tensor), which the kernel gathers from directly: one sector per entry for
all lanes instead of one per lane. The wrapper copies neither way: on the
solver's streams a lanes-minor copy of V did not pay for itself, and at
the 2L site, gathered three lanes a pass, lanes-major was faster (PERF.md).

Bound: bandwidth; `min_bytes` counts what one call must move, each byte
once, over the card's memory rate (3.35 TB/s on an H100 SXM).

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
# entries of one step of a warp of the kernel (kStep in the source): a warp
# walks a span of whole steps, the stream over the warps the card holds at
# once, and a span's first and last runs go to the carry stream; streams
# around a multiple of the step, and streams of many steps, are the edges
CHUNK = 256

# (vals' dtype, out's dtype) -> entry point
_FN_NAMES = {(torch.float32, torch.float32): "segment_sum_f32",
             (torch.float64, torch.float64): "segment_sum_f64",
             (torch.bfloat16, torch.bfloat16): "segment_sum_bf16",
             (torch.bfloat16, torch.float32): "segment_sum_bf16_f32"}
_fns: dict = {}


def build(verbose: bool = False) -> Path:
    """Compile the kernel if its hashed library is missing; return its path
    (see ops/_build.py)."""
    return _build.build(SOURCE, verbose)


def _load() -> dict:
    """{(dtype, out dtype): C entry point, "workspace": workspace size},
    building and loading the library once."""
    if not _fns:
        lib = _build.load(SOURCE)
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        for key, name in _FN_NAMES.items():
            fn = getattr(lib, name)
            fn.argtypes = [vp, ll, vp, ll, ll, vp, vp, vp, ll, ll, ll, ll,
                           ctypes.c_int, vp, ll, vp]
            fn.restype = ctypes.c_int
            _fns[key] = fn
        ws = lib.segment_sum_workspace_bytes
        ws.argtypes = [ll, ll, ll, ll, ctypes.c_int]
        ws.restype = ll
        _fns["workspace"] = ws
    return _fns


def _weights(vals: torch.Tensor, L: int, square_from: int) -> torch.Tensor:
    """w_l(vals) per lane: vals for l < square_from, vals * vals after."""
    if square_from >= L:
        return vals
    return torch.cat([vals[:square_from], (vals * vals)[square_from:]])


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type K1 forms its products and sums in: float32 for bfloat16,
    the values' own type otherwise. The port's bfloat16 solves sum, solve
    and take objective values in this type too (ops/objective.py,
    ops/tron_multi.py, ops/newton.py)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def host_scatter_only(t: torch.Tensor, what: str) -> None:
    """The solvers' scatter over a stream that is not sorted (the ELL of a
    problem built without its column-sorted copy, a row-sorted tail without
    its column-sorted one) is `index_add_` / `scatter_add_`, on the CPU
    only: on the card their atomics would sum in another order on every
    run, so there a problem carries the sorted copy and K1 sums it."""
    if t.is_cuda:
        raise ValueError(f"{what} on the card sums a column-sorted copy with "
                         f"K1 (one order every run), and this problem "
                         f"carries none")


def segment_sum_gather_reference(vals, V, idx, seg, num_segments: int, *,
                                 out=None, square_from=None):
    """Plain version: the contributions w * V[:, idx] (or w(vals)), then one
    index_add_ along the stream into `out` (zero-filled when None).
    Sortedness is not needed here, but the kernel relies on it. bfloat16
    computes the kernel's function: the values widened to float32, the
    products and the index_add_ in float32, one rounding into `out` (a
    bfloat16 index_add_ would round at every entry)."""
    L = (V if V is not None else vals).shape[0]
    sf = L if square_from is None else square_from
    acc = accumulate_dtype(vals.dtype)
    if V is None:
        contrib = _weights(vals.to(acc), L, sf)
    else:
        tv = vals[None, :].to(acc)
        rows = V[:, idx].to(acc)
        contrib = (torch.cat([tv * rows[:sf], (tv * tv) * rows[sf:]])
                   if sf < L else tv * rows)
    if out is None:
        return torch.zeros((L, num_segments), dtype=acc,
                           device=contrib.device).index_add_(
            1, seg, contrib).to(vals.dtype)
    if out.dtype == acc:
        return out.index_add_(1, seg, contrib)
    return out.copy_(out.to(acc).index_add_(1, seg, contrib))


def _check(vals, V, idx, seg, num_segments, out):
    """Shapes, id types and one device; returns L."""
    if seg.dim() != 1:
        raise ValueError(f"expected seg (T,); got {tuple(seg.shape)}")
    T = seg.shape[0]
    if V is None:
        if idx is not None:
            raise ValueError("idx needs V")
        if vals.dim() != 2 or vals.shape[1] != T:
            raise ValueError(f"expected contrib (L, T) and seg (T,); got "
                             f"{tuple(vals.shape)} and {tuple(seg.shape)}")
        L = vals.shape[0]
    else:
        if idx is None or idx.dim() != 1 or idx.shape[0] != T or \
                vals.dim() != 1 or vals.shape[0] != T or V.dim() != 2:
            raise ValueError(
                f"expected vals (T,), V (L, m), idx (T,), seg (T,); got "
                f"{tuple(vals.shape)}, {tuple(V.shape)}, "
                f"{None if idx is None else tuple(idx.shape)}, "
                f"{tuple(seg.shape)}")
        if idx.dtype != torch.int32:
            raise TypeError(f"idx must be int32; got {idx.dtype}")
        L = V.shape[0]
    if seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32; got {seg.dtype}")
    tensors = [t for t in (vals, V, idx, seg, out) if t is not None]
    if any(t.device != seg.device for t in tensors):
        raise ValueError("vals, V, idx, seg and out must be on one device")
    if V is not None and V.dtype != vals.dtype:
        raise TypeError(f"V and vals differ in dtype: {V.dtype}, "
                        f"{vals.dtype}")
    if out is not None and (out.shape != (L, num_segments) or out.dtype
                            not in (vals.dtype, accumulate_dtype(vals.dtype))):
        raise ValueError(f"out must be ({L}, {num_segments}) {vals.dtype} "
                         f"or {accumulate_dtype(vals.dtype)}; got "
                         f"{tuple(out.shape)} {out.dtype}")
    return L


def segment_sum_gather(vals: torch.Tensor, V: torch.Tensor | None,
                       idx: torch.Tensor | None, seg: torch.Tensor,
                       num_segments: int, *, out: torch.Tensor | None = None,
                       square_from: int | None = None) -> torch.Tensor:
    """out[l, seg[i]] += w_l(vals[i]) * V[l, idx[i]] (or w_l(vals[l, i])
    with V and idx None); see the module docstring. CPU tensors take the
    plain version; CUDA tensors launch the kernel. The order of `seg` is not
    checked here (the solver's `stack_blocks` checks it once): an unsorted
    stream gives wrong sums. The kernel drops segment ids outside
    [0, num_segments) and trusts `idx` to lie inside V."""
    L = _check(vals, V, idx, seg, num_segments, out)
    sf = L if square_from is None else max(int(square_from), 0)
    if seg.device.type == "cpu":
        return segment_sum_gather_reference(vals, V, idx, seg, num_segments,
                                            out=out, square_from=sf)
    if seg.device.type != "cuda":
        raise ValueError(f"unsupported device {seg.device}")
    if (vals.dtype, vals.dtype) not in _FN_NAMES:
        raise TypeError(f"the kernel takes float32, float64 or bfloat16; "
                        f"got {vals.dtype}")
    if out is not None and not out.is_contiguous():
        raise ValueError("out must be contiguous (it is updated in place)")
    if not _build.check_current_device(seg):
        with torch.cuda.device(seg.device):  # the launch goes to that card
            return segment_sum_gather(vals, V, idx, seg, num_segments,
                                      out=out, square_from=sf)
    vals, seg = vals.contiguous(), seg.contiguous()
    if V is None:
        v_lane = v_id = 0
    else:
        idx = idx.contiguous()
        if V.stride(1) != 1 and V.stride(0) != 1:
            V = V.contiguous()
        v_lane, v_id = V.stride(0), V.stride(1)
    accumulate = out is not None
    if out is None:
        out = torch.zeros((L, num_segments), dtype=vals.dtype,
                          device=vals.device)
    T = seg.shape[0]
    if L == 0 or T == 0 or num_segments == 0:
        return out
    fns = _load()
    ws_bytes = fns["workspace"](T, L, vals.element_size(),
                                out.element_size(), int(V is not None))
    if ws_bytes < 0:
        raise RuntimeError("segment_sum: the kernel's occupancy query failed")
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=vals.device)
          if ws_bytes else None)
    err = fns[vals.dtype, out.dtype](
        vals.data_ptr(), vals.stride(0) if V is None else 0,
        None if V is None else V.data_ptr(), v_lane, v_id,
        None if idx is None else idx.data_ptr(), seg.data_ptr(),
        out.data_ptr(), L, T, num_segments, sf, int(accumulate),
        None if ws is None else ws.data_ptr(), ws_bytes,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    segment_sum_sorted.launches += 1
    if segment_sum_sorted.device_launches is not None:
        segment_sum_sorted.device_launches.add_(1)
    return out


def segment_sum_sorted_reference(contrib: torch.Tensor, seg: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Plain version of `segment_sum_sorted`: zero-filled (L, S) plus one
    index_add_ along the stream."""
    return segment_sum_gather_reference(contrib, None, None, seg,
                                        num_segments)


def segment_sum_sorted(contrib: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """(L, T) contributions reduced into zero-filled (L, num_segments) sums
    over a non-decreasing int32 segment-id stream: the contrib form of
    `segment_sum_gather` without an accumulator."""
    return segment_sum_gather(contrib, None, None, seg, num_segments)


segment_sum_sorted.launches = 0
segment_sum_sorted.device_launches = None    # set by ops/device_loop.py


def min_bytes(L: int, T: int, S: int, itemsize: int, *,
              m_hit: int | None = None, S_hit: int | None = None,
              out_itemsize: int | None = None) -> int:
    """Bytes one call must move, each input read once and each output
    written once (the bandwidth bound's numerator); out's entries take
    out_itemsize bytes (default itemsize). Contrib form (m_hit None):
    L*T*itemsize + L*S*out_itemsize + 4*T. Gather form into an
    accumulator: the stream (vals, idx, seg), the m_hit distinct V columns
    it touches per lane, and the S_hit distinct outputs read and written."""
    o = itemsize if out_itemsize is None else out_itemsize
    if m_hit is None:
        return L * T * itemsize + L * S * o + 4 * T
    return (T * itemsize + 8 * T + L * min(T, m_hit) * itemsize
            + 2 * L * S_hit * o)
