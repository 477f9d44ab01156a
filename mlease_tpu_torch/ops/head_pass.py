"""The dense bfloat16 head's part of the solver's data passes, on the card.

    head_xv(hx, hw, out)
        out[l, b*Rb + r] += sum_h hx[b, r, h] * hw[l, b*H + h]
    head_xtv(hx, D, ids, out, square_from=L)
        out[l, ids[b*H + h]] += sum_r D[l, b*Rb + r] * x_l(hx[b, r, h])

hx is the flat-blocks (B, Rb, H) head or an (R, H) head (B = 1), stored
in bfloat16; hw, D and out are float32, lanes-major; ids are the head's B*H
distinct column ids (int32 or int64). x_l(h) = h for l < square_from and
bf16_rn(h * h) from square_from on: the square `hx * hx` rounds in
bfloat16 (the product of two bfloat16 values is exact in float32, then
rounded to nearest even), as the Jacobi diagonal takes it. `out` is updated
in place and returned.

This is ops/tron_multi.py's head product where the head is stored in
bfloat16 and the solve computes in float32 (`takes`): the kernels read the
stored head once a pass and widen it in registers, where the widening route
wrote a float32 copy of each block and ran a cuBLAS GEMM over it. Every
product and sum is float32; only their order differs from the GEMM's. On a
CUDA tensor each function launches the hand-written kernels of
`mlease_tpu_torch/csrc/head_pass.cu` (its header gives the design and the
bound) or raises; it refuses a CPU tensor (the CPU keeps the widening
route of ops/tron_multi.py). Neither kernel uses float atomics: the same
inputs give the same bits in every run, eagerly and inside a CUDA graph.
X'v sums per-grid-block partials in a workspace, one buffer per size,
allocated at its first call (before a device loop captures it: the loops
run every branch eagerly first) and kept, so calls of one size on one
card share it: they run on one stream, in order.

Counting: every call on the card adds one to the function's `launches`,
and where a device loop captures it, one on the card to its
`device_launches` (ops/device_loop.py), as K1 counts.

Bound: the head's bytes, R * H * 2 a pass, over the card's memory rate
(3.35 TB/s on an H100 SXM; `min_bytes`).

The kernels are built at first use with nvcc (sm_90a, plain C interface)
into `mlease_tpu_torch/_build/` and loaded with ctypes (ops/_build.py).
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from mlease_tpu_torch.ops import _build

SOURCE = _build.CSRC / "head_pass.cu"
MAX_LANES = 8          # lanes a launch takes; more go in chunks of 8

_fns: dict = {}
_workspaces: dict = {}


def _load() -> dict:
    if not _fns:
        lib = _build.load(SOURCE)
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        lib.head_pass_grid.argtypes = [ctypes.c_int, vp, ll, ll, ll, ll, ll,
                                       ll]
        lib.head_pass_grid.restype = ll
        lib.head_xv.argtypes = [vp, ll, ll, ll, ll, ll, vp, ll, vp, ll, ll,
                                ll, vp]
        lib.head_xv.restype = ctypes.c_int
        lib.head_xtv.argtypes = [vp, ll, ll, ll, ll, ll, vp, ll, ll, ll, vp,
                                 ctypes.c_int, vp, ll, vp, ll, vp]
        lib.head_xtv.restype = ctypes.c_int
        _fns.update(grid=lib.head_pass_grid, xv=lib.head_xv,
                    xtv=lib.head_xtv)
    return _fns


def takes(hx: torch.Tensor | None, dtype: torch.dtype,
          device: torch.device | str | None = None) -> bool:
    """True where the kernels compute a solve's head products: a head
    stored in bfloat16, a float32 solve, on the card (`device`, where the
    head is used: by default where it lies), (B, Rb, H) or (R, H). Every
    other head (float32, a bfloat16 solve, the CPU) keeps the widening
    route of ops/tron_multi.py."""
    if hx is None:
        return False
    where = hx.device if device is None else torch.device(device)
    return (hx.dtype == torch.bfloat16 and dtype == torch.float32
            and where.type == "cuda" and hx.dim() in (2, 3))


def _blocks(hx: torch.Tensor) -> torch.Tensor:
    return hx if hx.dim() == 3 else hx[None]


def _check(hx, vecs, out, L, what):
    if hx.dim() not in (2, 3) or hx.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the head must be (B, Rb, H) or (R, H) "
                         f"bfloat16; got {tuple(hx.shape)} {hx.dtype}")
    if out.stride(-1) != 1:
        raise ValueError(f"{what}: out must have unit stride along its "
                         f"columns (it is updated in place)")
    for t in (*vecs, out):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{what}: the vectors must be float32 (L, m); "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != hx.device:
            raise ValueError(f"{what}: every tensor must be on one device")
        if t.shape[0] != L:
            raise ValueError(f"{what}: {L} lanes expected; got "
                             f"{tuple(t.shape)}")


def _on_the_card(hx, what):
    if hx.device.type != "cuda":
        raise ValueError(f"{what}: the kernels run on the card; got a head "
                         f"on {hx.device}")


def _workspace(device, numel: int) -> torch.Tensor:
    key = (str(device), numel)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.empty(numel, dtype=torch.float32,
                                            device=device)
    return ws


def _geometry(hx):
    x = _blocks(hx)
    if x.stride(2) != 1:
        x = x.contiguous()
    B, Rb, H = x.shape
    return x, B, Rb, H, x.stride(0), x.stride(1)


def _counted(fn):
    fn.launches += 1
    if fn.device_launches is not None:
        fn.device_launches.add_(1)


def head_xv(hx: torch.Tensor, hw: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """out (L, B*Rb) += each block's head times its hw (L, B*H) columns;
    see the module docstring."""
    L = out.shape[0]
    _check(hx, (hw,), out, L, "head_xv")
    x, B, Rb, H, sb, sr = _geometry(hx)
    if hw.shape[1] < B * H or out.shape[1] < B * Rb:
        raise ValueError(f"head_xv: hw {tuple(hw.shape)} and out "
                         f"{tuple(out.shape)} do not cover {B} blocks of "
                         f"{Rb} x {H}")
    _on_the_card(hx, "head_xv")
    if not _build.check_current_device(hx):
        with torch.cuda.device(hx.device):
            return head_xv(hx, hw, out)
    fns = _load()
    hw = hw if hw.stride(1) == 1 else hw.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    for l0 in range(0, L, MAX_LANES):
        Lc = min(MAX_LANES, L - l0)
        cx = fns["grid"](0, x.data_ptr(), sb, sr, B, Rb, H, Lc)
        if cx <= 0:
            raise RuntimeError("head_xv: the kernel's occupancy query failed")
        err = fns["xv"](x.data_ptr(), sb, sr, B, Rb, H,
                        hw[l0].data_ptr(), hw.stride(0),
                        out[l0].data_ptr(), out.stride(0), Lc, cx, stream)
        if err != 0:
            raise RuntimeError(f"head_xv launch failed: CUDA error {err}")
    _counted(head_xv)
    return out


def head_xtv(hx: torch.Tensor, D: torch.Tensor, ids: torch.Tensor,
             out: torch.Tensor, square_from: int | None = None
             ) -> torch.Tensor:
    """out[:, ids] += D (L, B*Rb) times each block's head, squared from
    lane square_from on; see the module docstring."""
    L = D.shape[0]
    _check(hx, (D,), out, L, "head_xtv")
    x, B, Rb, H, sb, sr = _geometry(hx)
    if D.shape[1] < B * Rb or ids.dim() != 1 or ids.shape[0] != B * H \
            or ids.dtype not in (torch.int32, torch.int64) \
            or ids.device != hx.device:
        raise ValueError(f"head_xtv: D {tuple(D.shape)} and ids "
                         f"{tuple(ids.shape)} {ids.dtype} do not fit {B} "
                         f"blocks of {Rb} x {H}")
    sf = L if square_from is None else min(max(int(square_from), 0), L)
    _on_the_card(hx, "head_xtv")
    if not _build.check_current_device(hx):
        with torch.cuda.device(hx.device):
            return head_xtv(hx, D, ids, out, sf)
    fns = _load()
    ids = ids.contiguous()
    D = D if D.stride(1) == 1 else D.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    for l0 in range(0, L, MAX_LANES):
        Lc = min(MAX_LANES, L - l0)
        cx = fns["grid"](1, x.data_ptr(), sb, sr, B, Rb, H, Lc)
        if cx <= 0:
            raise RuntimeError("head_xtv: the kernel's occupancy query "
                               "failed")
        ws = _workspace(hx.device, B * cx * Lc * H)
        err = fns["xtv"](x.data_ptr(), sb, sr, B, Rb, H, D[l0].data_ptr(),
                         D.stride(0), Lc, sf - l0, ids.data_ptr(),
                         int(ids.dtype == torch.int64), out[l0].data_ptr(),
                         out.stride(0), ws.data_ptr(), cx, stream)
        if err != 0:
            raise RuntimeError(f"head_xtv launch failed: CUDA error {err}")
    _counted(head_xtv)
    return out


head_xv.launches = head_xtv.launches = 0
head_xv.device_launches = head_xtv.device_launches = None  # device_loop.py


def grid_blocks(hx: torch.Tensor, L: int) -> int:
    """Grid blocks along a head block's rows of an X'v launch of L <= 8
    lanes on the card (the order of its sums follows from it)."""
    x, B, Rb, H, sb, sr = _geometry(hx)
    return int(_load()["grid"](1, x.data_ptr(), sb, sr, B, Rb, H, L))


def min_bytes(R: int, H: int) -> int:
    """Bytes of the head a pass must read: R * H bfloat16 values."""
    return 2 * R * H
