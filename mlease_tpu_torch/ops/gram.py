"""Batched weighted Gram matrix: the port of the TPU kernel `gram_matrix`.

`gram_batched(x, d, prior_var_inv=None) -> (B, F, F)` with

    G[b] = x[b]' diag(d[b]) x[b] + diag(prior_var_inv[b])

x is (B, R, F), or (R, F) shared by every batch entry (the head-block build
has one X and L weight vectors); d is (B, R); prior_var_inv (B, F) or None.
`gram_matrix(x (R, F), d (R,), pvi (F,))` is the B = 1 case. It is the
Hessian of the per-item Newton step (ops/newton.py), of the Laplace
posterior covariance (ops/objective.py::dense_hessian) and of the head-block
preconditioner (ops/tron_multi.py::build_head_precond).

Types: float32 in and out (IEEE float32 FMAs, no TF32: the counterpart of
the TPU kernel's Precision.HIGHEST), bfloat16 x with float32 accumulation
and output (d is cast to x's type, the product d*x is formed in float32),
and float64 in and out, which the TPU kernel does not have.

On a CUDA tensor it launches the hand-written kernel in
`mlease_tpu_torch/csrc/gram.cu` (which replaces
mlease_tpu/ops/pallas/gram.py::gram_matrix; the source describes the design)
or raises. On a CPU tensor it runs the plain version,
`gram_batched_reference`. There is no fallback from the card to the plain
version. A split over rows is combined by a second pass in a fixed order,
without atomics, so the result is the same in every run and exactly
symmetric.

Bound: the larger of the bytes it must move, (B*R*F + B*R) * itemsize +
B*F^2 * out_itemsize (`min_bytes`) over 3.35 TB/s, and B*R*F*(F+2) FLOP
(`min_flops`: G is symmetric, so only its F*(F+1)/2 upper entries need
their R multiply-adds, plus one multiply per entry of x to fold d in) over
the card's peak for the type (H100 SXM: float32 67 TFLOP/s and float64 34
TFLOP/s outside the tensor cores, bf16 989 TFLOP/s dense tensor-core). One
long wide float32 problem is bound by operations, the per-item shapes by
bytes.

The kernel is built at first use with nvcc (ops/_build.py). Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mlease_tpu_torch.ops import _build

SOURCE = _build.CSRC / "gram.cu"

_FN_NAMES = {torch.float32: "gram_batched_f32",
             torch.float64: "gram_batched_f64",
             torch.bfloat16: "gram_batched_bf16"}
_fns: dict = {}

# launch policy of a row split: aim at this many blocks, never fewer rows
# than this in a split
_TARGET_BLOCKS = 528          # 4 per SM on an H100's 132 SMs
_MIN_SPLIT_ROWS = 512


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
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
    return _fns


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def launch_config(B: int, R: int, F: int, dtype: torch.dtype):
    """(tile, nsplit) of one call: the output tile side by F and type, and
    the number of row splits that fills the card when the tile pairs of all
    batch entries are too few blocks."""
    if F <= 16:
        tile = 16
    elif F <= 32:
        tile = 32
    elif F <= 64 or dtype == torch.float64:
        tile = 64
    else:
        tile = 128
    nt = -(-F // tile)
    blocks = B * nt * (nt + 1) // 2
    nsplit = 1
    if blocks < _TARGET_BLOCKS // 2:
        nsplit = max(1, min(-(-R // _MIN_SPLIT_ROWS),
                            -(-_TARGET_BLOCKS // blocks)))
    return tile, nsplit


def gram_batched_reference(x: torch.Tensor, d: torch.Tensor,
                           prior_var_inv: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version: x and d widened to the accumulate type, one einsum,
    plus the diagonal."""
    acc = accumulate_dtype(x.dtype)
    xa = x.to(acc)
    da = d.to(x.dtype).to(acc)
    if x.dim() == 2:
        G = torch.einsum("ri,br,rj->bij", xa, da, xa)
    else:
        G = torch.einsum("bri,br,brj->bij", xa, da, xa)
    if prior_var_inv is not None:
        G = G + torch.diag_embed(prior_var_inv.to(acc))
    return G


def gram_batched(x: torch.Tensor, d: torch.Tensor,
                 prior_var_inv: torch.Tensor | None = None) -> torch.Tensor:
    """(B, F, F) weighted Gram matrices in the accumulate type of x (float32
    for float32 and bfloat16, float64 for float64). CPU tensors take the
    plain version; CUDA tensors launch the kernel (launches counted in
    `gram_batched.launches`) or raise."""
    if d.dim() != 2 or x.dim() not in (2, 3) or x.shape[-2] != d.shape[1] \
            or (x.dim() == 3 and x.shape[0] != d.shape[0]):
        raise ValueError(f"expected x (B, R, F) or (R, F) and d (B, R); got "
                         f"{tuple(x.shape)} and {tuple(d.shape)}")
    B, R = d.shape
    F = x.shape[-1]
    if prior_var_inv is not None and tuple(prior_var_inv.shape) != (B, F):
        raise ValueError(f"expected prior_var_inv ({B}, {F}); got "
                         f"{tuple(prior_var_inv.shape)}")
    if x.device != d.device or (prior_var_inv is not None
                                and prior_var_inv.device != x.device):
        raise ValueError("x, d and prior_var_inv must be on one device")
    if x.device.type == "cpu":
        return gram_batched_reference(x, d, prior_var_inv)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _FN_NAMES:
        raise TypeError(f"the kernel takes float32, float64 or bfloat16; "
                        f"got {x.dtype}")
    if not _build.check_current_device(x):
        with torch.cuda.device(x.device):  # the launch goes to the current card
            return gram_batched(x, d, prior_var_inv)
    acc = accumulate_dtype(x.dtype)
    x = x.contiguous()
    d = d.to(x.dtype).contiguous()
    pvi = None if prior_var_inv is None else \
        prior_var_inv.to(acc).contiguous()
    out = torch.empty((B, F, F), dtype=acc, device=x.device)
    if B == 0 or F == 0:
        return out
    if R == 0:
        out.zero_()
        return out if pvi is None else out + torch.diag_embed(pvi)
    tile, nsplit = launch_config(B, R, F, x.dtype)
    ws = torch.empty((B, nsplit, F, F), dtype=acc, device=x.device) \
        if nsplit > 1 else None
    fn = _load()[x.dtype]
    err = fn(x.data_ptr(), d.data_ptr(),
             None if pvi is None else pvi.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), B, R, F,
             R * F if x.dim() == 3 else 0, tile, nsplit,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram_batched launch failed: CUDA error {err}")
    gram_batched.launches += 1
    return out


gram_batched.launches = 0


def gram_matrix(x: torch.Tensor, d: torch.Tensor,
                prior_var_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The B = 1 case: x (R, F), d (R,), prior_var_inv (F,) -> (F, F)."""
    pvi = None if prior_var_inv is None else prior_var_inv[None]
    return gram_batched(x, d[None], pvi)[0]


def min_bytes(B: int, R: int, F: int, itemsize: int, out_itemsize: int,
              shared_x: bool = False) -> int:
    """Bytes one call must move: each input read once (a shared x once for
    all entries), the output written once."""
    nx = R * F if shared_x else B * R * F
    return (nx + B * R) * itemsize + B * F * F * out_itemsize


def min_flops(B: int, R: int, F: int) -> int:
    """Operations the function needs: G is symmetric, so R multiply-adds
    (2 operations each) for each of its F*(F+1)/2 upper entries, plus one
    multiply per entry of x to fold d in."""
    return B * R * F * (F + 1) + B * R * F
