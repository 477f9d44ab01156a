"""Batched weighted Gram matrix: the port of the TPU kernel `gram_matrix`.

`gram_batched(x, d, prior_var_inv=None) -> (B, F, F)` with

    G[b] = x[b]' diag(d[b]) x[b] + diag(prior_var_inv[b])

x is (B, R, F), or (R, F) shared by every batch entry (the head-block build
has one X and L weight vectors); d is (B, R); prior_var_inv (B, F) or None.
`gram_matrix(x (R, F), d (R,), pvi (F,))` is the B = 1 case. It is the
Hessian of the per-item Newton step (ops/newton.py), of the Laplace
posterior covariance (ops/objective.py::dense_hessian) and of the head-block
preconditioner (ops/tron_multi.py::build_head_precond).

Types: float32 in and out, bfloat16 x with float32 accumulation and output
(d is cast to x's type, the product d*x is formed in float32), and float64
in and out, which the TPU kernel does not have. float32 keeps float32
accuracy on every route: where the tensor cores are used it is the split
product 3xTF32 (the counterpart of the TPU kernel's Precision.HIGHEST, which
is a multi-pass bf16 emulation on the matrix unit), never TF32 alone.

On a CUDA tensor it launches a hand-written kernel from
`mlease_tpu_torch/csrc/gram*.cu` (which replace
mlease_tpu/ops/pallas/gram.py::gram_matrix; gram.cu describes the design) or
raises. On a CPU tensor it runs the plain version, `gram_batched_reference`.
There is no fallback from the card to the plain version. `launch_config`
picks one of three variants by shape, type and alignment, in the open:
"item" (many tiny problems, F <= 16 with 16-byte rows: bytes-bound, a warp
per entry behind a cp.async double buffer), "mma" (F above 16: a cp.async
ring feeding mma.sync tensor-core products; up to three entries sharing one
X per block) and "fma" (what those two do not take: F <= 16 with ragged
rows or few long entries, ragged bf16 rows). A split over rows is combined by a second pass in a
fixed order, without atomics, so the result is the same in every run and
exactly symmetric.

Bound: the larger of the bytes it must move, (B*R*F + B*R) * itemsize +
B*F^2 * out_itemsize (`min_bytes`) over 3.35 TB/s, and B*R*F*(F+2) FLOP
(`min_flops`: G is symmetric, so only its F*(F+1)/2 upper entries need
their R multiply-adds, plus one multiply per entry of x to fold d in) over
the best rate the card (H100 SXM) has for a product of the type's accuracy:
float32 165 TFLOP/s (three TF32 tensor-core products at 495 TFLOP/s, which
beats the 67 TFLOP/s outside the tensor cores), float64 67 TFLOP/s (DMMA),
bf16 989 TFLOP/s. One long wide problem is bound by operations, the
per-item shapes by bytes.

The kernels are built at first use with nvcc (ops/_build.py), the four
sources in parallel. Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from mlease_tpu_torch.ops import _build

SOURCE = _build.CSRC / "gram.cu"                  # "item" and "fma"
MMA_SOURCES = {torch.float32: _build.CSRC / "gram_mma_f32.cu",
               torch.bfloat16: _build.CSRC / "gram_mma_bf16.cu",
               torch.float64: _build.CSRC / "gram_mma_f64.cu"}
SOURCES = [SOURCE, *MMA_SOURCES.values()]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# C signatures after (x, d, pvi, out): see the sources' extern "C" blocks
_ARGTYPES = {
    "fma": [_PTR] * 5 + [_LL] * 4 + [_INT, _INT, _PTR],
    "mma": [_PTR] * 5 + [_LL] * 4 + [_INT, _INT, _INT, _PTR],
    "item": [_PTR] * 4 + [_LL] * 4 + [_INT, _PTR]}
_fns: dict = {}

# launch policy of a row split: aim at this many blocks (4 per SM on an
# H100's 132 SMs; 2 for the 128-wide mma tile, of which one fits an SM),
# never fewer rows than this in a split
_TARGET_BLOCKS = 528
_TARGET_BLOCKS_MMA128 = 264
_MIN_SPLIT_ROWS = 512
# the item variant: widest F, bytes of X per warp buffer, persistent grid
# (2 blocks of 8 warps per SM), and the batch from which long entries
# (R above one buffer) still go to it rather than to a row split
_ITEM_MAX_F = 16
_ITEM_CHUNK_BYTES = 4096
_ITEM_WARPS = 8
_ITEM_MAX_BLOCKS = 264
_ITEM_MIN_BATCH = 132
_MMA_LANES = 3                # entries sharing one X that a block takes

ROUTES = {("mma", torch.float32): "3xTF32 mma.sync.m16n8k8",
          ("mma", torch.bfloat16): "2 x bf16 mma.sync.m16n8k16",
          ("mma", torch.float64): "DMMA mma.sync.m8n8k4",
          "item": "FMA behind a cp.async double buffer",
          "fma": "FMA, one shared-memory stage"}


class GramLaunch(NamedTuple):
    """What one call launches: the variant ("item", "mma" or "fma"), its
    output tile side, the number of row splits, and the batch entries that
    one block takes over one staged X."""
    variant: str
    tile: int
    nsplit: int
    lanes: int


def route(variant: str, dtype: torch.dtype) -> str:
    """The arithmetic of a variant for a type, for a measurement's row."""
    return ROUTES.get((variant, dtype)) or ROUTES[variant]


def build(verbose: bool = False) -> list[Path]:
    """Compile the sources whose hashed library is missing, in parallel;
    return the libraries' paths (see ops/_build.py)."""
    return _build.build_many(SOURCES, verbose)


def _load() -> dict:
    """{(variant, dtype): C entry point}, building and loading once."""
    if not _fns:
        build()
        fns = {}
        for dtype, suffix in _SUFFIX.items():
            libs = {"fma": _build.load(SOURCE), "item": _build.load(SOURCE),
                    "mma": _build.load(MMA_SOURCES[dtype])}
            for variant, lib in libs.items():
                fn = getattr(lib, f"gram_{variant}_{suffix}")
                fn.argtypes = _ARGTYPES[variant]
                fn.restype = ctypes.c_int
                fns[variant, dtype] = fn
        _fns.update(fns)
    return _fns


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def launch_config(B: int, R: int, F: int, dtype: torch.dtype,
                  shared_x: bool = False, aligned: bool = True) -> GramLaunch:
    """The variant, tile, row splits and lanes of one call. `aligned` says
    that x's first element lies on a 16-byte boundary; together with rows
    of a 16-byte multiple that admits 16-byte cp.async copies."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows16 = aligned and (F * itemsize) % 16 == 0
    item_rows = _ITEM_CHUNK_BYTES // (_ITEM_MAX_F * itemsize)
    if rows16 and F <= _ITEM_MAX_F and (B >= _ITEM_MIN_BATCH
                                        or R <= item_rows):
        return GramLaunch("item", _ITEM_MAX_F, 1, 1)
    lanes = 1
    # above the item width the tensor cores take it; ragged float32 and
    # float64 rows are staged element by element, ragged bf16 rows are not
    if F > _ITEM_MAX_F and (rows16 or itemsize >= 4):
        variant = "mma"
        if shared_x and B > 1:
            tile, lanes = 64, _MMA_LANES
        else:
            tile = 128 if F > 64 and dtype != torch.float64 else 64
    else:
        variant = "fma"
        if F <= 16:
            tile = 16
        elif F <= 32:
            tile = 32
        elif F <= 64 or dtype == torch.float64:
            tile = 64
        else:
            tile = 128
    nt = -(-F // tile)
    blocks = -(-B // lanes) * nt * (nt + 1) // 2
    target = _TARGET_BLOCKS_MMA128 if (variant, tile) == ("mma", 128) \
        else _TARGET_BLOCKS
    nsplit = 1
    if blocks < target // 2:
        nsplit = max(1, min(R // _MIN_SPLIT_ROWS, target // blocks))
    return GramLaunch(variant, tile, nsplit, lanes)


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
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32, float64 or bfloat16; "
                        f"got {x.dtype}")
    if not _build.check_current_device(x):
        with torch.cuda.device(x.device):  # the launch goes to the current card
            return gram_batched(x, d, prior_var_inv)
    acc = accumulate_dtype(x.dtype)
    x = x.contiguous()
    d = d.to(x.dtype).contiguous()
    if x.dtype == torch.bfloat16:
        d = d.float()       # the kernels take bf16-rounded weights as float32
    pvi = None if prior_var_inv is None else \
        prior_var_inv.to(acc).contiguous()
    out = torch.empty((B, F, F), dtype=acc, device=x.device)
    if B == 0 or F == 0:
        return out
    if R == 0:
        out.zero_()
        return out if pvi is None else out + torch.diag_embed(pvi)
    cfg = launch_config(B, R, F, x.dtype, x.dim() == 2,
                        x.data_ptr() % 16 == 0)
    fn = _load()[cfg.variant, x.dtype]
    head = (x.data_ptr(), d.data_ptr(),
            None if pvi is None else pvi.data_ptr(), out.data_ptr())
    dims = (B, R, F, R * F if x.dim() == 3 else 0)
    stream = torch.cuda.current_stream().cuda_stream
    if cfg.variant == "item":
        blocks = min(-(-B // _ITEM_WARPS), _ITEM_MAX_BLOCKS)
        err = fn(*head, *dims, blocks, stream)
    else:
        ws = torch.empty((B, cfg.nsplit, F, F), dtype=acc, device=x.device) \
            if cfg.nsplit > 1 else None
        tail = (cfg.tile, cfg.nsplit) if cfg.variant == "fma" else \
            (cfg.tile, cfg.lanes, cfg.nsplit)
        err = fn(*head, None if ws is None else ws.data_ptr(), *dims, *tail,
                 stream)
    if err != 0:
        raise RuntimeError(f"gram_batched launch failed ({cfg}): CUDA error "
                           f"{err}")
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
