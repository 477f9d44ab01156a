"""Streaming ADMM for datasets larger than device memory, ported to PyTorch.

Port of mlease_tpu/train/streaming.py (StreamingAdmmTrainer,
build_group_solver). Each group's x-update is one of the in-memory
trainer's solves (train/admm.py): by default the flat multi-RHS TRON solve
of ops/tron_multi.py (the group's blocks folded into one stacked problem,
every λ lane at once, Jacobi PCG), so K1's three fused tail reduces run
inside every group solve; flat_blocks=False or pcg="head_block" (or a
group whose stacked ids would pass int32, as the JAX gate decides:
`groups_fit`) solves the group's blocks as independent problems on the
same stacked data (K1 as well; with "head_block" each block's head Gram
is one K2 call, on a bfloat16 head its bf16-in route), past int32 in
consecutive sub-stacks; multi_rhs=False runs the batched reference TRON
over the (λ, block) lanes. Blocks live in host RAM as
packed groups, and each ADMM iteration runs

  phase 1: for each group g: the next group's host->device copies are
           issued on a copy stream, then g is solved on the compute stream
           and its partial consensus sums taken;
  phase 2: z-update from the accumulated xbar/ubar;
  phase 3: u_g += x_g - z per group.

**One program per group.** Each group's x-update is the in-memory
trainer's device loop (train/admm.py::_SolveLoop): on the card one launch
of a CUDA graph that loops until the group's solves stop, captured at the
group's first solve and kept; on the CPU the same branches run eagerly.
The iteration reads the host once, as the JAX one does: the diffs, the
sample logliks and every group's (Newton, CG) trips, in one copy; rho_eff
and eps reach the device without a blocking copy. `build_group_solver`,
the host-driven solve, is the reference the loops are held to.

**Slots and overlap.** A captured graph reads fixed addresses, so a
streamed group lands in one of two persistent slots (`_Slot`), used
alternately and each sized for the largest group that ships, and its loop
reads views of that slot; resident groups keep their own device tensors
and their own loop. Group g+1's copies are issued on a dedicated copy
stream *before* group g is solved, the compute stream waits on an event
before it uses them, and the copy into a slot waits on an event that the
compute stream records after the last solve that read the slot (with an
odd number of shipping groups the first and the last share a slot from
one iteration to the next). The compact-wire rebuilds (COO scatter of the
head, inverse-permutation gather of the row-sorted tail) run on the copy
stream too, after their copies, into the slot. A group's loop keeps its
solver state; groups whose state has one layout share it (they are solved
one after another), and all of a trainer's loops share one graph memory
pool. The slots and that state are solver state, outside the residency
budget below (`_cap_budget` reserves the two slots).

**Host arrays.** Each group's arrays are converted once, group by group, to
the compute dtype (the dense head to head_dtype: a bfloat16 head is a host
`torch.bfloat16` tensor), stacked (block offsets added to every id, so a
shipped group is already the flat problem `stack_blocks` would build, and
its id ranges and sortedness are checked here once, on the host) and copied
into page-locked memory (`pin_host`; a copy from pageable memory is staged
and does not overlap).

**Consensus.** Device-resident (z, every u_g and the iteration's x_g on the
card; one small readback of diffs and logliks per iteration) or
host-resident (u_g on the host, shipped with its group; x_g fetched back).
Both take the partial sums and the z-update on the device and the u-update
as `u + x - z` elementwise, so both placements give the same bits.

**Residency** under `resident_head_budget_gb`: (tier 1) dense heads per
group while they fit, (tier 2) whole groups, (tier 3) the remaining groups'
column-sorted tails; on the card the budget is capped by what the device
can hold beside the streamed working set (see `_cap_budget`).

**Compact wire**: a streamed head ships as its COO triplet and is
scattered into the dense form on the card; a streamed row-sorted tail is
gathered from the column-sorted copy by the inverse permutation.

**Mesh** (`mesh=`, a 1-D block mesh of parallel/mesh.py): every rank
builds the trainer from the whole list of groups; each group is padded to a
multiple of the block dimension and each rank streams only its own slice of
each group. The partial sums of all its groups are one all_reduce(SUM) per
iteration, in both consensus placements; padded blocks are masked out of
them and keep zero duals. Never the flat solve, and never the compact wire
(compact_wire=True raises, "auto" stays dense), as in the JAX package. Every
rank returns the same result (u gathered over the ranks).

**bfloat16** (`dtype=torch.bfloat16`, as the JAX package runs it): the host
values, the dense head, u, x and z are bfloat16, the host arrays pinned
`torch.bfloat16` tensors (numpy has no bfloat16); the solves take K1's
bfloat16 entry. dual_layout raises, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import math
import mmap
import os
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import (BlockedData, _numpy_dtype,
                                           pack_rows, to_hybrid)
from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math, head_pass
from mlease_tpu_torch.ops.device_loop import DeviceClock, device_span
from mlease_tpu_torch.ops.objective import class_balance_eps_scale
from mlease_tpu_torch.ops.segment_sum import accumulate_dtype
from mlease_tpu_torch.ops.tron_multi import (MultiProblem, SubStacks,
                                             column_copy, stack_fits,
                                             substack_ranges, substacks_of)
from mlease_tpu_torch.collectives import all_gather, all_reduce
from mlease_tpu_torch.parallel.mesh import (BLOCK_AXIS, axis_size,
                                            block_sharding, local_blocks,
                                            mesh_device)
from mlease_tpu_torch.train.admm import (MAX_NTEST_EVENTS, AdmmConfig,
                                         AdmmResult, _close_loops,
                                         _graph_pool, _lambda_key, _leaves,
                                         _rho_table,
                                         _SolveLoop, _to_device,
                                         build_x_update, sample_loglik_lanes,
                                         solver_mode, unstack_problem,
                                         x_prior)
from mlease_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

_STREAM_FIELDS = ("indices", "values", "y", "weight", "offset", "present",
                  "tail_rows", "tail_cols", "tail_vals",
                  "tail_c_rows", "tail_c_cols", "tail_c_vals")
_CTAIL = ("tail_c_rows", "tail_c_cols", "tail_c_vals")
# the arrays held in the compute dtype (the head has its own storage dtype)
_VALUE_FIELDS = ("values", "y", "weight", "offset", "tail_vals",
                 "tail_c_vals")


def _nbytes(a) -> int:
    return 0 if a is None else int(a.nbytes)


def _group_stream_bytes(g) -> int:
    """Device bytes a fully-resident group pins: every per-iteration data
    transfer (both tail layouts included), the head excluded."""
    return sum(_nbytes(getattr(g, f, None)) for f in _STREAM_FIELDS)


def _ctail_bytes(g) -> int:
    return sum(_nbytes(getattr(g, f, None)) for f in _CTAIL)


class _LockedPages(mmap.mmap):
    """Anonymous pages holding one page-locked host tensor
    (_locked_copy); unregistered before they go back to the system, with
    the last tensor on them."""

    ptr = None

    def __del__(self):
        if self.ptr is not None:
            try:
                torch.cuda.cudart().cudaHostUnregister(self.ptr)
            except Exception:  # noqa: BLE001 - the runtime may be gone
                pass


def _locked_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of host tensor t in page-locked memory of its own size (to
    the page), registered with the card (cudaHostRegister) and freed with
    its last user. torch's caching host allocator (pin_memory=True) rounds
    every block up to a power of two (ctr-100m's 1.6 GB group head to 2.1
    GB) and keeps freed blocks."""
    n = t.numel() * t.element_size()
    if n == 0:                     # no bytes to lock
        return torch.empty(t.shape, dtype=t.dtype)
    pages = _LockedPages(-1, n)
    raw = torch.frombuffer(pages, dtype=torch.uint8, count=n)
    err = int(torch.cuda.cudart().cudaHostRegister(raw.data_ptr(), n, 0))
    if err != 0:
        raise RuntimeError(f"cudaHostRegister of {n} bytes failed: "
                           f"cudaError {err}")
    pages.ptr = raw.data_ptr()
    out = raw.view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def _flat_tensors(x):
    """Every tensor inside x: nested tuples (named ones too), lists and
    dict values."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat_tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _flat_tensors(v)


def _head_coo(head: torch.Tensor) -> tuple:
    """Host-side COO of the dense (B, R, H) head (once at construction):
    int32 flat row b*R + r, uint8 head column (int32 above 256 columns),
    the value in the head's dtype."""
    B, R, H = head.shape
    b, r, h = (head != 0).nonzero(as_tuple=True)
    rows = (b * R + r).to(torch.int32)
    cols = h.to(torch.uint8 if H <= 256 else torch.int32)
    return rows, cols, head[b, r, h]


def _pad_group_tails(g: BlockedData, T_max: int) -> BlockedData:
    """Pad one group's tail layouts from T to T_max columns, bit-exactly.

    BOTH triplets APPEND (row R-1, col n-1, val 0.0) entries, the padding
    convention of core/dataset.to_hybrid: row R-1 / col n-1 keep the
    appended padding sorted in each stream, and appending means real
    entries keep their positions. Each added entry contributes +0.0 to the
    last row/column slot: a float-exact no-op. On the card K1 sums each
    sorted stream in fixed steps from its start, and the padding moves
    where the steps fall: a padded group's X'v, Xv and Jacobi diagonal
    differ from the unpadded layout's in their last bits, so a run's bits
    follow its layout (streaming.pad.tails). At liblinear.epsilon 0.01 the
    solver's stop tests carry that difference to the solver's tolerance,
    as they carry a change in the order of the rows (ROADMAP.md C, known
    trait 10); at 1e-8 the two layouts' z agree within 1e-6 * max|z|
    (chip_smoke.py phase 24 (a))."""
    B, T = g.tail_rows.shape
    P = T_max - T
    if P <= 0:
        return g

    def app(a, fill=0):
        return (None if a is None
                else np.concatenate(
                    [a, np.full((B, P), fill, a.dtype)], axis=1))

    return g._replace(tail_rows=app(g.tail_rows, g.padded_rows - 1),
                      tail_cols=app(g.tail_cols, g.dim - 1),
                      tail_vals=app(g.tail_vals),
                      tail_c_rows=app(g.tail_c_rows, g.padded_rows - 1),
                      tail_c_cols=app(g.tail_c_cols, g.dim - 1),
                      tail_c_vals=app(g.tail_c_vals))


def _tail_inv_perm(tail_cols: np.ndarray) -> np.ndarray:
    """Per-block inverse of the stable column sort: row-sorted tail =
    column-sorted tail indexed by this permutation (exactly: the same
    argsort core/dataset.to_hybrid builds the tail_c_* copy with). Returned
    flat, with block b's positions offset by b*T, for the stacked arrays."""
    B, T = tail_cols.shape
    inv = np.empty((B, T), np.int32)
    ar = np.arange(T, dtype=np.int32)
    for b in range(B):
        ordc = np.argsort(tail_cols[b], kind="stable")
        inv[b, ordc] = ar + b * T
    return inv


def _pad_head_coo_shared(wire: dict) -> None:
    """Pad every compact head-COO triplet to one shared length with
    (0, 0, 0.0) entries, exact no-ops under the additive scatter. The JAX
    package does it to compile one scatter program per run; here it makes
    every streamed group's COO buffers one size, which the caching
    allocator then reuses from group to group."""
    lens = [w["head_coo"][0].shape[0] for w in wire.values()
            if "head_coo" in w]
    if len(lens) <= 1 or max(lens) == min(lens):
        return
    target = max(lens)
    for w in wire.values():
        coo = w.get("head_coo")
        if coo is None or coo[0].shape[0] == target:
            continue
        pad = target - coo[0].shape[0]
        w["head_coo"] = tuple(
            torch.cat([a, torch.zeros(pad, dtype=a.dtype)]) for a in coo)


def _split_substacks(prob: MultiProblem, ranges) -> SubStacks:
    """A shipped group whose ids are offset per sub-stack (_host_group) as
    the SubStacks of its consecutive block ranges: views, nothing copied.
    Rows, ELL entries and the head's ids are block-major; every tail
    stream holds T entries a block."""
    B = ranges[-1][1]
    probs = []
    for b0, b1 in ranges:
        def cut(a):
            if a is None or a.dim() == 3:       # the (B, Rb, H) head
                return None if a is None else a[b0:b1]
            per = a.shape[0] // B
            return a[b0 * per:b1 * per]
        probs.append(MultiProblem(*(cut(a) for a in prob)))
    return SubStacks(tuple(probs), tuple(ranges))


def _column_order(indices: np.ndarray, ranges) -> torch.Tensor:
    """The column-sorted order of a group's ELL entries, (B*R*K,) int32:
    for each sub-stack of `ranges`, the stable order of its flat entries
    by their stacked column ids (indices (B, R, K), offset per sub-stack
    as _host_group offsets them), as positions in that sub-stack. The
    offsets keep blocks apart, so one sort orders every block's entries
    at once: train/admm.py::unstack_problem makes the column-sorted copy
    from it."""
    return torch.from_numpy(np.concatenate([
        np.argsort(indices[b0:b1].reshape(-1), kind="stable")
        .astype(np.int32) for b0, b1 in ranges]))


def _gather_row_sorted(tc, inv, out):
    """Row-sorted tail from the column-sorted one (flat, stacked): each of
    the three streams `tc` gathered by `inv` into its `out` tensor."""
    return tuple(torch.index_select(a, 0, inv, out=o)
                 for a, o in zip(tc, out))


def _scatter_head_dense(hrows, hcols, hvals, out):
    """The dense (B, R, H) head from its COO triplet, into `out`.
    index_add_ into zeros, not an assignment: the shared-length padding
    adds (0, 0, 0.0) entries, which add nothing into slot (0, 0), while the
    real entries are unique nonzeros of a zero base, so add equals set bit
    for bit."""
    H = out.shape[2]
    flat = out.view(-1).zero_()
    lin = hrows.to(torch.int64) * H + hcols.to(torch.int64)
    flat.index_add_(0, lin, hvals)
    return out


class _Slot:
    """One persistent device buffer per field (name -> (numel, dtype)),
    sized for the largest group that ships the field; a group's arrays are
    views of them (`view`). `free` (on the card) is the event the compute
    stream records after the last solve that read the slot."""

    def __init__(self, sizes: dict, device: torch.device):
        self.buf = {f: torch.empty(numel, dtype=dt, device=device)
                    for f, (numel, dt) in sizes.items()}
        self.free = torch.cuda.Event() if device.type == "cuda" else None

    def view(self, field: str, shape, dtype) -> torch.Tensor:
        b = self.buf[field]
        if b.dtype != dtype:
            raise TypeError(f"slot field {field}: {dtype}, not {b.dtype}")
        return b[:math.prod(shape)].view(shape)

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buf.values())


def _lanes_problem(prob, nblocks: int, n: int, dtype, csc_perm=None):
    """A group's stacked problem (or SubStacks) as the lanes solve takes
    it: each sub-stack unstacked (train/admm.py::unstack_problem), with
    its share of the column order `csc_perm`."""
    parts, off = [], 0
    for p, (b0, b1) in substacks_of(prob, nblocks):
        e = p.indices.numel()
        parts.append(unstack_problem(
            p, b1 - b0, n, dtype,
            None if csc_perm is None else csc_perm[off:off + e]))
        off += e
    return (SubStacks(tuple(parts), prob.ranges)
            if isinstance(prob, SubStacks) else parts[0])


def _refresh(parts, probs) -> None:
    """Write a streamed lanes group's problem, unstacked anew from its
    slot, into the tensors its loop reads: the views of the slot are
    those tensors already; what unstacking derives is copied in place."""
    for part, (prob, _r) in zip(parts, probs, strict=True):
        for d, s in zip(_tensors(part.prob), _tensors(prob), strict=True):
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _device_hbm_bytes(dev: torch.device) -> int:
    """The card's memory (bytes); MLEASE_HBM_GB overrides it."""
    env = os.environ.get("MLEASE_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    return int(torch.cuda.get_device_properties(dev).total_memory)


def _check_sorted_ids(a: np.ndarray, bound: int, name: str,
                      is_sorted: bool) -> None:
    """The flat problem's id streams: inside [0, bound), and segment ids
    non-decreasing (the kernel relies on both); checked once, on the
    host."""
    if a.size == 0:
        return
    if is_sorted and bool(np.any(a[1:] < a[:-1])):
        raise ValueError(f"{name} must be non-decreasing (sorted tail)")
    if int(a.min()) < 0 or int(a.max()) >= bound:
        raise ValueError(f"{name} holds ids outside [0, {bound})")


def groups_fit(groups) -> bool:
    """The JAX streaming gate's int32 terms (max over the groups of B*n and
    of B*R below 2^31, ops/tron_multi.py::stack_fits): the flat solve
    only then; past them a group's blocks solve in sub-stacks."""
    return all(stack_fits(g.nblocks, g.dim, g.padded_rows) for g in groups)


def build_group_solver(max_newton_iter: int, max_cg_iter: int,
                       mode: str = "flat", pcg=True,
                       relaxation: float = 1.0) -> Callable:
    """The (lambda x block) x-update of one group (no consensus), in one of
    the in-memory trainer's solve modes (train/admm.py::build_x_update):
    "flat" (the group's B blocks folded into one stacked problem with a
    joint per-λ trust region and the strictest block's tolerance, the JAX
    package's solve_flat), "per_block" (each block its own problem, the
    JAX vmap of tron_multi) or "lanes" (the batched reference TRON over
    the (λ, block) lanes, the JAX vmap(vmap(tron))).

    solver(prob, present, z, u, rho_eff, eps, csc_perm=None) takes the
    group's stacked MultiProblem without its prior (ids offset into the
    group's (B*R rows, B*n columns) space, every array but the head flat),
    present (B, n) bool, z (L, n), the group's u (L, B, n), rho_eff (L,),
    eps (B,) the blocks' tolerances, and for a lanes solve on the card the
    column order of the group's ELL entries (_column_order); it returns
    (x (L, B, n), newton_trips, cg_trips), the trips summed over the
    solve's counters as the JAX group solve sums them."""
    solve = build_x_update(mode, max_newton_iter, max_cg_iter, pcg,
                           relaxation)

    def run(prob: MultiProblem, present, z, u, rho_eff, eps, csc_perm=None):
        if mode == "lanes":
            prob = _lanes_problem(prob, u.shape[1], z.shape[1], z.dtype,
                                  csc_perm)
        x, trips = solve(prob, present, z, u, rho_eff, eps)
        nt, cg = trips.sum(0)
        return x, int(nt), int(cg)

    return run


class StreamingAdmmTrainer:
    """ADMM over a list of host-resident block groups.

    groups: BlockedData whose block counts sum to the logical num.blocks,
    in a list the caller keeps (left as it is) or an iterable that hands
    the trainer the only reference to each group (the train pipeline's
    hand-off, pipeline.py::_streaming_trainer): then each group's host
    arrays are freed once their page-locked copies exist, and a group
    converted to hybrid here drops its ELL once its hybrid form exists.
    Groups may have different padded shapes.

    consensus_device: "auto" (default) keeps z / u / x in device memory
    whenever 2*L*nblocks*n*itemsize fits resident_head_budget_gb (checked
    against the full budget: consensus state is solver state, not data);
    True forces it; False keeps u on the host.

    device: where the solves run ("cuda" by default; "cpu" only when asked,
    as the tests do). pin_host: page-lock the host arrays on the card's
    machine (False keeps them pageable, for measuring what pinning buys).
    """

    def __init__(self, groups: Sequence[BlockedData], vocab,
                 config: AdmmConfig, test_rows=None, mesh=None,
                 resident_head: str | bool = "auto",
                 resident_head_budget_gb: float = 8.0,
                 consensus_device: str | bool = "auto",
                 compact_wire: str | bool = "auto",
                 pad_tails: str | bool = "auto",
                 device: str | torch.device = "cuda",
                 pin_host: bool = True):
        if config.dual_layout:
            raise NotImplementedError(
                "dual layout in streaming mode: the CSC arrays double the "
                "per-iteration PCIe transfer; use the HBM-resident trainer")
        if compact_wire is True and mesh is not None:
            raise ValueError("compact_wire=True requires a single device "
                             "(each rank streams its own blocks dense "
                             "under a mesh)")
        # the trainer's own list: with a hand-off it holds the only
        # reference to each group, and each entry is replaced (the
        # original freed) as it is normalised, padded and pinned
        groups = list(groups)
        self.mesh = mesh
        if mesh is not None:
            device = mesh_device(mesh)
        self.mode = solver_mode(config.multi_rhs, config.flat_blocks,
                                False, config.pcg, mesh,
                                fits=groups_fit(groups))
        # the mask and relaxation of an x-update (build_x_update's finish)
        self._finish = build_x_update(self.mode, config.max_newton_iter,
                                      config.max_cg_iter, config.pcg,
                                      config.relaxation).finish
        self._solve_args = (config.pcg, config.max_newton_iter,
                            config.max_cg_iter)
        self.device = dev = resolve_device(device)
        on_card = dev.type == "cuda"
        # numpy has no bfloat16: a bfloat16 run normalises its host arrays
        # to float32 here and rounds them once, group by group, into host
        # torch.bfloat16 tensors (_host_group), as the head already is
        dt = _numpy_dtype(config.dtype) or np.dtype(np.float32)
        hdt = config.head_dtype or config.dtype

        # ---- one-time host normalization, group by group, in place -----
        for i in range(len(groups)):
            g = groups[i]
            if config.head_size > 0 and g.head is None:
                g = to_hybrid(g, config.head_size, column_sorted=True,
                              head_dtype=hdt)
            conv = {f: np.asarray(getattr(g, f), dt)
                    for f in _VALUE_FIELDS
                    if getattr(g, f) is not None
                    and getattr(g, f).dtype != dt}
            if g.head is not None:
                conv["head"] = _to_head_dtype(g.head, hdt)
            g = g._replace(**conv)
            # hand-constructed hybrid groups without a host-sorted tail
            # copy: sort once here (the permutation to_hybrid builds)
            if g.tail_cols is not None and g.tail_c_cols is None:
                ords = [np.argsort(c, kind="stable") for c in g.tail_cols]
                g = g._replace(**{
                    f"tail_c_{k}": np.stack([a[o] for a, o in zip(
                        getattr(g, f"tail_{k}"), ords)])
                    for k in ("rows", "cols", "vals")})
            groups[i] = g
            del g

        # ---- shared tail shapes ----------------------------------------
        # Padding every group's tails to the run-wide max T makes every
        # group's arrays one size (the caching allocator reuses them from
        # group to group); "auto" pads unless that adds more than 25% of
        # the tail bytes. Bit-exact (see _pad_group_tails).
        self._tail_orig_T: dict[int, int] = {}
        tails_ok = all(g.tail_rows is not None for g in groups)
        if pad_tails in ("auto", True) and tails_ok and len(groups) > 1:
            widths = [g.tail_rows.shape[1] for g in groups]
            T_max = max(widths)
            orig = sum(w * g.nblocks for w, g in zip(widths, groups))
            padded = sum(T_max * g.nblocks for g in groups)
            if T_max > min(widths) and (
                    pad_tails is True or padded <= 1.25 * orig):
                for i in range(len(groups)):
                    if groups[i].tail_rows.shape[1] < T_max:
                        self._tail_orig_T[i] = groups[i].tail_rows.shape[1]
                        groups[i] = _pad_group_tails(groups[i], T_max)
                logger.info(
                    "tail shapes harmonized to T=%d across %d groups "
                    "(%d padded; +%.1f%% tail bytes)", T_max, len(groups),
                    len(self._tail_orig_T),
                    100.0 * (padded - orig) / max(orig, 1))

        self.nblocks = sum(g.nblocks for g in groups)
        self.real_nblocks = [g.nblocks for g in groups]
        # under a mesh: each group padded to the block dimension, this
        # rank's slice of it; pad_idx[gi] the padded local blocks (masked)
        self._group_comm = None
        self.pad_idx: list = [None] * len(groups)
        self._pad_host: dict = {}
        if mesh is not None:
            self._group_comm = mesh.get_group(BLOCK_AXIS)
            for i in range(len(groups)):
                groups[i], valid = local_blocks(mesh, groups[i])
                if not valid.all():
                    self._pad_host[i] = torch.as_tensor(np.nonzero(~valid)[0])
                    self.pad_idx[i] = self._pad_host[i].to(dev)
        self.vocab = vocab
        self.config = config
        self.dim = groups[0].dim
        self.lambdas = [float(l) for l in config.lambdas]
        self.rhos = config.resolved_rhos()
        self.use_head = groups[0].head is not None
        self.eps_scales = [class_balance_eps_scale(g.y, g.nrows)
                           for g in groups]

        # ---- compact-wire host encodings need the unstacked tails -------
        want_compact = (self.use_head and mesh is None
                        and (compact_wire is True or compact_wire == "auto"))
        inv_perms = ([_tail_inv_perm(g.tail_cols) for g in groups]
                     if want_compact and tails_ok else None)

        # ---- stack once on the host, check once, pin ------------------
        self._pinned = on_card and pin_host
        # X'v sums a group's ELL slots over their column-sorted copy with
        # K1 (ops/tron_multi.py::with_column_copy, ops/objective.py::
        # _sorted_sum): the copy's order is made here, once, and ships with
        # the group; the multi-RHS solves' copy on every device, the lanes
        # solve's on the card
        self._csc_order = on_card or self.mode != "lanes"
        self.groups = []
        self.ranges: list[list[tuple[int, int]]] = []
        self.csc_perms: list[torch.Tensor | None] = []
        for i in range(len(groups)):
            self.groups.append(self._host_group(groups[i]))
            groups[i] = None    # the originals go once their copies exist
        del groups

        # ---- consensus placement --------------------------------------
        budget_gb = (float("inf") if resident_head is True
                     else float(resident_head_budget_gb))
        L = len(self.lambdas)
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        consensus_bytes = 2 * L * self.nblocks * self.dim * itemsize
        if consensus_device == "auto":
            self._consensus_device = (consensus_bytes
                                      <= budget_gb * (1 << 30))
        else:
            self._consensus_device = bool(consensus_device)

        if (self.use_head and resident_head in ("auto", True) and on_card):
            budget_gb = self._cap_budget(budget_gb, consensus_bytes)

        # ---- streams ---------------------------------------------------
        self._copy_stream = torch.cuda.Stream(dev) if on_card else None

        # ---- tiered data residency (resident_head_budget_gb) ----------
        #   tier 1 — every group's dense head (the dominant transfer);
        #   tier 2 — whole groups, in order, while they fit;
        #   tier 3 — remaining groups' column-sorted tail triplets.
        self._resident_heads: dict[int, tuple] = {}
        self._resident_groups: dict[int, tuple] = {}
        self._resident_ctails: dict[int, tuple] = {}
        self._wire: dict[int, dict] = {}
        if self.use_head and resident_head in ("auto", True):
            budget = budget_gb * (1 << 30)
            pinned = 0
            for gi, g in enumerate(self.groups):
                hb = _nbytes(g.head) + _nbytes(g.head_ids)
                if hb <= budget:
                    self._resident_heads[gi] = (self._to_dev(g.head),
                                                self._to_dev(g.head_ids))
                    budget -= hb
                    pinned += hb
            for gi, g in enumerate(self.groups):
                if gi not in self._resident_heads:
                    continue
                gb = _group_stream_bytes(g) + self._order_bytes(gi)
                if gb > budget:
                    break
                self._resident_groups[gi] = self._ship(
                    gi, lambda f, shape, dt: torch.empty(shape, dtype=dt,
                                                         device=dev))
                budget -= gb
                pinned += gb
            for gi, g in enumerate(self.groups):
                if gi in self._resident_groups:
                    continue
                cb = _ctail_bytes(g)
                if 0 < cb <= budget:
                    self._resident_ctails[gi] = tuple(
                        self._to_dev(getattr(g, f).view(-1)) for f in _CTAIL)
                    budget -= cb
                    pinned += cb
            if on_card:
                torch.cuda.synchronize(dev)
            logger.info(
                "resident mode: %.2f GB pinned in device memory "
                "(%d/%d heads + %d/%d full groups + %d sorted tails); "
                "consensus state (%.2f GB) %s",
                pinned / (1 << 30), len(self._resident_heads),
                len(self.groups), len(self._resident_groups),
                len(self.groups), len(self._resident_ctails),
                consensus_bytes / (1 << 30),
                "device-resident" if self._consensus_device
                else "host-resident")

        # ---- compact wire (after the ladder: pinned tiers never ship) ---
        if want_compact:
            for gi, g in enumerate(self.groups):
                if gi in self._resident_groups:
                    continue
                w: dict = {}
                if gi not in self._resident_heads:
                    coo = _head_coo(g.head)
                    # only a win while the head is actually sparse
                    if sum(_nbytes(a) for a in coo) < _nbytes(g.head) // 2:
                        w["head_coo"] = coo
                if inv_perms is not None:
                    w["tail_inv"] = torch.from_numpy(inv_perms[gi])
                    inv_perms[gi] = None   # the wire's entry holds it alone
                if w:
                    self._wire[gi] = w
            _pad_head_coo_shared(self._wire)
            for w in self._wire.values():
                for k in w:
                    w[k] = (tuple(self._lock(a) for a in w[k])
                            if isinstance(w[k], tuple) else self._lock(w[k]))
            if self._wire:
                logger.info(
                    "compact wire: %d/%d streamed groups re-encoded "
                    "(%.2f GB -> %.2f GB per iteration)",
                    len(self._wire), len(self.groups),
                    self._dense_wire_bytes() / (1 << 30),
                    self.stream_wire_bytes() / (1 << 30))
        del inv_perms

        # ---- the two slots of the groups that ship, and the loops -------
        # (a group ships its data unless wholly resident, and its u with
        # host-resident consensus)
        ship = [gi for gi in range(len(self.groups))
                if gi not in self._resident_groups
                or not self._consensus_device]
        self._slot_of = {gi: k % 2 for k, gi in enumerate(ship)}
        self._slots: list[_Slot] = []     # made at the first copy
        self._loops: dict[int, _SolveLoop] = {}   # freed with the trainer
        weakref.finalize(self, _close_loops, self._loops).atexit = False
        self._pool = _graph_pool(dev)
        # run()'s clock: each group's loop, the data passes' head (and its
        # kernels' or torch's products' share) and K1 parts (and K1's bf16
        # entry's share), and the compute stream's stalls on a group's
        # copies
        self.clock = DeviceClock(dev, ("head_pass", "head_fused",
                                       "head_gemm", "tail_pass",
                                       "tail_bf16", "wire_wait"))

        self.lam_vec = torch.as_tensor(np.stack([
            admm_math.per_feature_lambda(l, self.dim, config.lambda_map,
                                         vocab) for l in self.lambdas]),
            dtype=config.dtype, device=dev)

        # sample-test loglik arrays (first MAX_NTEST_EVENTS rows)
        self.test_arrays = None
        if test_rows:
            blk = pack_rows(list(test_rows)[:MAX_NTEST_EVENTS], vocab)
            self.test_arrays = tuple(
                torch.as_tensor(np.asarray(a), dtype=t, device=dev)
                for a, t in ((blk.indices, None), (blk.values, config.dtype),
                             (blk.y, config.dtype),
                             (blk.weight, config.dtype),
                             (blk.offset, config.dtype)))

    # ------------------------------------------------------------------
    def _pin(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor in page-locked memory (when pinning), else t: a
        run's host buffers of x, z and u, from torch's caching host
        allocator (which reuses them from iteration to iteration)."""
        if not self._pinned:
            return t
        p = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        p.copy_(t)
        return p

    def _lock(self, t: torch.Tensor) -> torch.Tensor:
        """A page-locked copy of t (when pinning), else t: the arrays the
        trainer keeps for its life (its groups, their column orders and
        compact-wire encodings), in pages of their own (_locked_copy)."""
        return _locked_copy(t) if self._pinned else t

    def _host_group(self, g: BlockedData) -> BlockedData:
        """g with every array a host tensor, pinned on the card's machine,
        ids offset into the group's stacked space, and the stacked id
        streams checked once. Where the group's stacked ids would pass
        int32, each block's ids are offset from the first block of its
        sub-stack instead (substack_ranges, kept in self.ranges), so every
        sub-stack is the problem stack_blocks would build of its blocks,
        and each is checked on its own. A group with ELL slots gets the
        column-sorted order of each sub-stack's ELL entries (kept in
        self.csc_perms: int32 positions in the sub-stack's flat entries;
        a lanes solve's on the card only)."""
        B, R, n = g.nblocks, g.padded_rows, g.dim
        ranges = substack_ranges(B, n, R)
        self.ranges.append(ranges)
        first = np.concatenate([np.full(b1 - b0, b0, np.int64)
                                for b0, b1 in ranges])
        local = (np.arange(B, dtype=np.int64) - first)[:, None]
        offs = {"rows": local * R, "cols": local * n}

        def stacked(a, off):
            return None if a is None else (a + off).astype(np.int32)

        ids = {"indices": stacked(g.indices, offs["cols"][..., None]),
               "tail_rows": stacked(g.tail_rows, offs["rows"]),
               "tail_cols": stacked(g.tail_cols, offs["cols"]),
               "tail_c_rows": stacked(g.tail_c_rows, offs["rows"]),
               "tail_c_cols": stacked(g.tail_c_cols, offs["cols"])}
        if g.head_ids is not None:
            ids["head_ids"] = stacked(np.broadcast_to(g.head_ids, (B, len(
                g.head_ids))), offs["cols"]).reshape(-1)
        self.csc_perms.append(
            self._lock(_column_order(ids["indices"], ranges))
            if self._csc_order and g.indices.shape[2] > 0 else None)
        for b0, b1 in ranges:
            nb = b1 - b0
            if g.tail_rows is not None:
                _check_sorted_ids(ids["tail_rows"][b0:b1].reshape(-1),
                                  nb * R, "tail_rows", True)
                _check_sorted_ids(ids["tail_cols"][b0:b1].reshape(-1),
                                  nb * n, "tail_cols", False)
            if g.tail_c_cols is not None:
                _check_sorted_ids(ids["tail_c_cols"][b0:b1].reshape(-1),
                                  nb * n, "tail_c_cols", True)
                _check_sorted_ids(ids["tail_c_rows"][b0:b1].reshape(-1),
                                  nb * R, "tail_c_rows", False)
        out = {}
        for f in ("indices", "values", "y", "weight", "offset", "present",
                  "head", "head_ids", *("tail_" + k for k in (
                      "rows", "cols", "vals", "c_rows", "c_cols",
                      "c_vals"))):
            a = ids[f] if f in ids else getattr(g, f)
            if a is None:
                out[f] = None
                continue
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            if f in _VALUE_FIELDS:
                t = t.to(self.config.dtype)
            out[f] = self._lock(t.contiguous())
        # nrows is read on the host, not shipped: a copy of its own, so
        # that the group keeps nothing of the caller's arrays
        return g._replace(nrows=np.array(g.nrows), **out)

    def _order_bytes(self, gi: int) -> int:
        """Device bytes of group gi's column order once shipped: the order
        itself for a lanes solve, the column-sorted copy (two int32 ids
        and a value a slot) for a multi-RHS solve."""
        perm = self.csc_perms[gi]
        if perm is None or self.mode == "lanes":
            return _nbytes(perm)
        return 2 * _nbytes(perm) + _nbytes(self.groups[gi].values)

    def _to_dev(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """A resident array: copied once, on the compute stream."""
        return None if t is None else t.to(self.device, non_blocking=True)

    def _reserve_bytes(self) -> dict:
        """What `_cap_budget` keeps free beside the pinned tiers, in bytes:
        the card ("hbm"), the two streamed slots ("slots"), the x slab
        ("x"), and the transients with the solver's workspace ("slack", of
        which "work" is the workspace)."""
        L = len(self.lambdas)
        item = torch.empty((), dtype=self.config.dtype).element_size()
        group_dev = max(_group_stream_bytes(g) + _nbytes(g.head)
                        + _nbytes(g.head_ids) for g in self.groups)
        hbm = _device_hbm_bytes(self.device)
        # the widening route's two blocks; none where the kernels take the
        # head (ops/head_pass.py)
        widened = 0 if head_pass.takes(self.groups[0].head, self.config.dtype,
                                       self.device) else 2
        head_block = max(g.padded_rows * g.head.shape[2] for g in self.groups)
        work = max(32 * L * g.nblocks * (g.padded_rows + g.dim) * item
                   for g in self.groups)
        slack = int(max(_nbytes(g.head) for g in self.groups)
                    + widened * head_block * item + work + 0.05 * hbm)
        return {"hbm": hbm, "slots": 2 * group_dev,
                "x": L * self.nblocks * self.dim * item, "slack": slack,
                "work": work}

    def _cap_budget(self, budget_gb: float, consensus_bytes: int) -> float:
        """Cap the pin budget by what the card can hold beside the rest.

        The pinned tiers share device memory with the double-buffered
        streamed working set (2 groups in flight), the consensus state and
        the iteration's x slab, and transients. The port reserves, beside
        those: one dense head at its stored width (a compact head's scatter
        output while the previous group's head is still alive); two blocks
        of the head at the compute width (the block widened and squared by
        ops/tron_multi._widen: a narrow head is never widened whole), where
        the head takes that route (the kernels of ops/head_pass.py, which
        a bfloat16 head under a float32 solve on the card takes, widen
        none); the
        solver's workspace, about 32 vectors of the largest group's rows
        and columns per lane (measured peaks are in PERF.md); and 5% of the
        card for the caching allocator (it rounds blocks up and keeps each
        stream's freed blocks cached). A budget above what is left degrades
        to less pinning instead of an out-of-memory error."""
        r = self._reserve_bytes()
        hbm, group_dev, x_bytes, slack = (r["hbm"], r["slots"] // 2, r["x"],
                                          r["slack"])
        avail = (hbm - slack - 2 * group_dev - x_bytes
                 - (consensus_bytes if self._consensus_device else 0))
        if budget_gb * (1 << 30) > max(avail, 0):
            logger.warning(
                "resident budget %.1f GB exceeds safe device headroom "
                "%.1f GB (%.1f GB - 2x%.2f GB streamed buffers - %.2f GB "
                "consensus+x - %.2f GB reserved); capping", budget_gb,
                max(avail, 0) / (1 << 30), hbm / (1 << 30),
                group_dev / (1 << 30), (consensus_bytes + x_bytes)
                / (1 << 30), slack / (1 << 30))
            budget_gb = max(avail, 0) / (1 << 30)
        return budget_gb

    # ------------------------------------------------------------------
    def residency_report(self) -> dict:
        """The actual pinned state (the ladder may skip tiers that did not
        fit)."""
        return {
            "consensus_device": bool(self._consensus_device),
            "heads_pinned": len(self._resident_heads),
            "full_groups_pinned": len(self._resident_groups),
            "sorted_tails_pinned": len(self._resident_ctails),
            "compact_wire_groups": len(self._wire),
            "n_groups": len(self.groups),
        }

    def _held_bytes(self) -> dict:
        """What the trainer holds after its build, each storage counted
        once: "page_locked_bytes", the host bytes of its page-locked
        tensors (the groups, their compact-wire encodings and column
        orders; 0 where nothing is pinned), and "resident_bytes", the
        device bytes of its resident tiers (heads, whole groups, sorted
        tails)."""
        def total(tensors, keep):
            seen = {}
            for t in tensors:
                if keep(t):
                    st = t.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
            return sum(seen.values())
        return {
            "page_locked_bytes": total(_flat_tensors(
                (self.groups, list(self._wire.values()), self.csc_perms)),
                lambda t: t.is_pinned()),
            "resident_bytes": total(_flat_tensors(
                (self._resident_heads, self._resident_groups,
                 self._resident_ctails)), lambda t: t.device.type != "cpu")}

    def _dense_wire_bytes(self) -> int:
        """Per-iteration host->device bytes without compact re-encoding
        (pinned tiers still excluded)."""
        total = 0
        for gi, g in enumerate(self.groups):
            if gi in self._resident_groups:
                continue
            total += sum(_nbytes(getattr(g, f)) for f in (
                "indices", "values", "y", "weight", "offset", "present",
                "tail_rows", "tail_cols", "tail_vals"))
            total += _nbytes(self.csc_perms[gi])
            if gi not in self._resident_ctails:
                total += _ctail_bytes(g)
            if self.use_head and gi not in self._resident_heads:
                total += _nbytes(g.head) + _nbytes(g.head_ids)
        return total

    def stream_wire_bytes(self) -> int:
        """Actual per-iteration host->device data bytes: pinned tiers never
        re-ship; compact-wire groups ship COO heads and one tail layout
        plus the permutation instead of two layouts. (Host-resident
        consensus also ships each group's u and fetches its x.) The JAX
        package's count, but for head_ids, which ship stacked: B*H ids
        per group instead of H."""
        total = 0
        for gi, g in enumerate(self.groups):
            if gi in self._resident_groups:
                continue
            w = self._wire.get(gi, {})
            total += sum(_nbytes(getattr(g, f)) for f in (
                "indices", "values", "y", "weight", "offset", "present"))
            total += _nbytes(self.csc_perms[gi])
            if "tail_inv" in w:
                total += _nbytes(w["tail_inv"])
            else:
                total += sum(_nbytes(getattr(g, f)) for f in (
                    "tail_rows", "tail_cols", "tail_vals"))
            if gi not in self._resident_ctails:
                total += _ctail_bytes(g)
            if not self.use_head or gi in self._resident_heads:
                continue
            if "head_coo" in w:
                total += sum(_nbytes(a) for a in w["head_coo"])
            else:
                total += _nbytes(g.head)
            total += _nbytes(g.head_ids)
        return total

    def sample_loglik(self, z: torch.Tensor) -> np.ndarray:
        return sample_loglik_lanes(*self.test_arrays, z).to(
            torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    def _slot_fields(self, gi: int) -> dict:
        """field -> (shape, dtype) of what group gi ships into its slot."""
        g, out = self.groups[gi], {}
        if not self._consensus_device:
            out["u"] = ((len(self.lambdas), g.nblocks, self.dim),
                        self.config.dtype)
        if gi in self._resident_groups:
            return out
        B, R = g.nblocks, g.padded_rows
        perm = self.csc_perms[gi]
        fields = {"indices": g.indices.view(B * R, -1),
                  "values": g.values.view(B * R, -1), "y": g.y,
                  "weight": g.weight, "offset": g.offset,
                  "present": g.present, "perm": perm}
        if perm is not None and self.mode != "lanes":
            # the column-sorted copy, gathered on the card by the order
            fields.update(csc_rows=perm, csc_cols=perm,
                          csc_vals=g.values.view(-1))
        if self.use_head:
            fields.update({f: getattr(g, f) for f in (
                "tail_rows", "tail_cols", "tail_vals")})
            if gi not in self._resident_ctails:
                fields.update({f: getattr(g, f) for f in _CTAIL})
            if gi not in self._resident_heads:
                fields.update(head=g.head, head_ids=g.head_ids)
        for f, a in fields.items():
            if a is not None:
                out[f] = (tuple(a.shape), a.dtype)
        return out

    def _slot_sizes(self, gis) -> dict:
        """field -> (the largest numel over the groups gis, dtype)."""
        sizes: dict = {}
        for gi in gis:
            for f, (shape, dt) in self._slot_fields(gi).items():
                numel = max(math.prod(shape), sizes.get(f, (0, dt))[0])
                sizes[f] = (numel, dt)
        return sizes

    def _ship(self, gi: int, dst):
        """Group gi's arrays on the device, copied into dst(field, shape,
        dtype) tensors on the current stream (non-blocking from page-locked
        memory), the compact-wire rebuilds into them after their copies,
        and a multi-RHS solve's column-sorted copy of the ELL slots
        gathered by their shipped order: (the group's MultiProblem without
        its prior, present, the column order of a lanes solve on the card
        or None). Resident heads and column-sorted tails are used as they
        are."""
        g = self.groups[gi]
        w = self._wire.get(gi, {})
        dev = self.device

        def put(f, t):
            if t is None:
                return None
            d = dst(f, tuple(t.shape), t.dtype)
            d.copy_(t, non_blocking=True)
            return d

        head = {}
        if self.use_head:
            if gi in self._resident_ctails:
                tc = self._resident_ctails[gi]
            else:
                tc = tuple(put(f, getattr(g, f).view(-1)) for f in _CTAIL)
            if "tail_inv" in w:
                inv = w["tail_inv"].view(-1).to(dev, non_blocking=True)
                t = _gather_row_sorted(tc, inv, [
                    dst(f, (inv.numel(),), a.dtype) for f, a in zip(
                        ("tail_rows", "tail_cols", "tail_vals"), tc)])
            else:
                t = tuple(put(f, getattr(g, f).view(-1)) for f in (
                    "tail_rows", "tail_cols", "tail_vals"))
            if gi in self._resident_heads:
                head_x, head_ids = self._resident_heads[gi]
            elif "head_coo" in w:
                head_x = _scatter_head_dense(
                    *(a.to(dev, non_blocking=True) for a in w["head_coo"]),
                    out=dst("head", tuple(g.head.shape), g.head.dtype))
                head_ids = put("head_ids", g.head_ids)
            else:
                head_x, head_ids = put("head", g.head), put("head_ids",
                                                            g.head_ids)
            head = dict(head_x=head_x, head_ids=head_ids,
                        tail_rows=t[0], tail_cols=t[1],
                        tail_vals=t[2], tail_c_rows=tc[0],
                        tail_c_cols=tc[1], tail_c_vals=tc[2])
        B, R = g.nblocks, g.padded_rows
        prob = MultiProblem(
            indices=put("indices", g.indices.view(B * R, -1)),
            values=put("values", g.values.view(B * R, -1)),
            y=put("y", g.y.view(-1)), weight=put("weight", g.weight.view(-1)),
            offset=put("offset", g.offset.view(-1)), prior_mean=None,
            prior_var_inv=None, **head)
        perm = put("perm", self.csc_perms[gi])
        if perm is not None and self.mode != "lanes":
            prob = self._with_column_copy(gi, prob, perm, dst)
            perm = None
        return prob, put("present", g.present), perm

    def _with_column_copy(self, gi: int, prob: MultiProblem,
                          perm: torch.Tensor, dst) -> MultiProblem:
        """prob with the column-sorted copy of its ELL slots
        (ops/tron_multi.py::column_copy), each sub-stack's gathered by its
        share of the shipped order `perm`, into dst(field, shape, dtype)
        tensors: the copy stack_blocks makes of those blocks (one stable
        sort), in block order."""
        R = self.groups[gi].padded_rows
        K = prob.indices.shape[1]
        parts = [column_copy(prob.indices[b0 * R:b1 * R],
                             prob.values[b0 * R:b1 * R],
                             perm[b0 * R * K:b1 * R * K])
                 for b0, b1 in self.ranges[gi]]
        copy = {}
        for f, *pieces in zip(("csc_rows", "csc_cols", "csc_vals"), *parts):
            d = dst(f, (perm.numel(),), pieces[0].dtype)
            copy[f] = torch.cat(pieces, out=d)
        return prob._replace(**copy)

    def _put_group(self, gi: int, u_host: torch.Tensor | None = None):
        """Issue group gi's host->device copies (and its compact-wire
        rebuilds) into its slot on the copy stream, once the compute stream
        has passed the last solve that read the slot; return (the group's
        MultiProblem without its prior, present, u on the device or None,
        the event the compute stream waits on before using them, or None
        when nothing was copied, the column order of a lanes solve on the
        card or None). Pinned tiers hand back their device arrays as they
        are."""
        if gi in self._resident_groups and u_host is None:
            prob, present, perm = self._resident_groups[gi]
            return prob, present, None, None, perm
        if not self._slots:
            self._slots = [_Slot(self._slot_sizes(
                [g for g, k in self._slot_of.items() if k == s]),
                self.device) for s in range(min(len(self._slot_of), 2))]
        slot = self._slots[self._slot_of[gi]]
        cs = self._copy_stream
        ctx = torch.cuda.stream(cs) if cs is not None else \
            contextlib.nullcontext()
        with ctx:
            if cs is not None:
                cs.wait_event(slot.free)
            u_dev = None
            if u_host is not None:
                u_dev = slot.view("u", tuple(u_host.shape), u_host.dtype)
                u_dev.copy_(u_host, non_blocking=True)
            if gi in self._resident_groups:
                prob, present, perm = self._resident_groups[gi]
            else:
                prob, present, perm = self._ship(gi, slot.view)
        if cs is None:
            return prob, present, u_dev, None, perm
        ev = torch.cuda.Event()
        ev.record(cs)
        return prob, present, u_dev, ev, perm

    def _group_problems(self, gi: int, prob, perm) -> list:
        """[(problem, (b0, b1))] of group gi's solve: its sub-stacks (views)
        and, for the lanes solve, each unstacked."""
        B = self.groups[gi].nblocks
        if len(self.ranges[gi]) > 1:
            prob = _split_substacks(prob, self.ranges[gi])
        if self.mode == "lanes":
            prob = _lanes_problem(prob, B, self.dim, self.config.dtype, perm)
        return substacks_of(prob, B)

    def _solve_group(self, gi: int, prob, present, z, u, rho_eff, eps,
                     perm):
        """Group gi's x-update through its _SolveLoop, made (and on the
        card captured, sharing the state of a loop of the same layout) at
        its first solve: (x (L, B, n), its (Newton, CG) trips summed over
        the solve's counters, (2,) on the device). A streamed lanes
        group's problem is unstacked anew into the loop's tensors."""
        loop = self._loops.get(gi)
        if loop is None:
            pcg, max_newton_iter, max_cg_iter = self._solve_args
            loop = _SolveLoop(
                self.mode, self._group_problems(gi, prob, perm),
                len(self.lambdas), self.dim, pcg, max_newton_iter,
                max_cg_iter, z, u, rho_eff, eps,
                share=list(self._loops.values()))
            loop.own_loop(self._pool, self.clock, f"group{gi}").prepare()
            self._loops[gi] = loop
        elif self.mode == "lanes" and gi not in self._resident_groups:
            _refresh(loop.parts, self._group_problems(gi, prob, perm))
        loop.solve(z, u, rho_eff, eps)
        x = self._finish(loop.x(), present, x_prior(z, u), z)
        return x, loop.trips().sum(0)

    def _iterate(self, z, u_groups, rho_eff, rho_base, inner_eps: float,
                 track_ll: bool):
        """Phases 1-3 of one iteration: every group's solve (the next
        group's copies issued first), the z-update from the partial sums,
        u_g += x_g - z in place. Returns (z_new, diffs, sample logliks or
        None, the (G, 2) newton/cg trips); the one readback of diffs,
        logliks and trips is its only host sync (a gloo mesh's collectives
        aside)."""
        cfg = self.config
        dtype, dev = cfg.dtype, self.device
        # a bfloat16 run's z- and u-updates in float32, z and u rounded
        # once each (train/admm.py::build_admm_step)
        acc = accumulate_dtype(dtype)
        L, N, G = len(self.lambdas), self.nblocks, len(self.groups)
        dev_consensus = self._consensus_device
        compute = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None
        # every group's tolerances, the products in float64 rounded once
        # to the compute dtype, in one copy
        eps_all = _to_device(np.concatenate(
            [inner_eps * scale for scale in self.eps_scales]), dtype,
            dev).split([len(s) for s in self.eps_scales])
        xsum = usum = None
        trips = []
        x_keep: list[torch.Tensor] = []
        # host-resident consensus ships each group's u with its data
        ship_u = [None] * G if dev_consensus else u_groups
        pending = self._put_group(0, ship_u[0])
        for gi in range(G):
            prob, present, u_dev, ready, perm = pending
            # the next group's copies go out BEFORE this group's solve (into
            # the other slot): they overlap the solve
            if gi + 1 < G:
                pending = self._put_group(gi + 1, ship_u[gi + 1])
            if ready is not None:
                # the wire not hidden under the solves queued before
                with device_span("wire_wait"):
                    compute.wait_event(ready)
            u_g = u_groups[gi] if dev_consensus else u_dev
            x, trip = self._solve_group(gi, prob, present, z, u_g, rho_eff,
                                        eps_all[gi], perm)
            trips.append(trip)
            pad = self.pad_idx[gi]
            if pad is not None:         # mesh padding: out of the sums
                x = x.index_fill(1, pad, 0.0)
            xs, us = x.sum(1), u_g.sum(1)
            xsum = xs if xsum is None else xsum + xs
            usum = us if usum is None else usum + us
            if compute is not None and gi in self._slot_of:
                # the slot's last reader is queued: its next copy may follow
                self._slots[self._slot_of[gi]].free.record(compute)
            if dev_consensus:
                x_keep.append(x)
            else:
                xh = self._pin(torch.empty(x.shape, dtype=dtype))
                x_keep.append(xh.copy_(x, non_blocking=True))
            del prob, present, u_dev, x, u_g, perm
        trip_dev = torch.stack(trips)
        if self._group_comm is not None:
            # the mesh's collectives of the iteration: every rank's partial
            # sums, then the same z on every rank; the trips summed beside
            sums = all_reduce(torch.stack([xsum, usum]), "sum",
                              self._group_comm)
            xsum, usum = sums[0], sums[1]
            all_reduce(trip_dev, "sum", self._group_comm)
        # consensus shrinkage uses the BASE rho; adaptation only shapes the
        # x-subproblem (RegressionAdmmTrain.java:368-380 vs :648-658)
        v = ((xsum + usum) / N).to(acc)
        rho = rho_base[:, None].to(acc)
        lam_vec = self.lam_vec.to(acc)
        if cfg.regularizer == 2:
            z_new = admm_math.z_update_l2(
                v, lam_vec, rho, N, self.vocab.intercept_index,
                cfg.penalize_intercept)
        else:
            z_new = admm_math.z_update_l1(
                v, lam_vec, rho, N, self.vocab.intercept_index,
                cfg.penalize_intercept,
                reference_compat=cfg.reference_l1_compat)
        z_new = z_new.to(dtype)
        diffs_dev = admm_math.max_abs_diff(z_new, z, axis=-1)
        read = [diffs_dev]
        if track_ll:
            read.append(sample_loglik_lanes(*self.test_arrays, z_new))
        read.append(trip_dev.view(-1))
        z_ref = z_new
        if not dev_consensus and dev.type == "cuda":
            z_ref = self._pin(torch.empty(z_new.shape, dtype=dtype))
            z_ref.copy_(z_new, non_blocking=True)
        # the iteration's one host sync, the clock's slots beside; the host
        # copies of x and z (host consensus) landed before it
        host = self.clock.read(read).numpy()
        diffs = host[:L]
        lls = host[L:2 * L] if track_ll else None
        trip_mat = host[-2 * G:].astype(np.int64).reshape(G, 2)
        # Phase 3, u += x - z (admm_math.u_update in place, so a
        # host-resident u stays in its page-locked buffer): the same
        # elementwise (u + x) - z on either side gives the same bits; in
        # float32 for a bfloat16 run, rounded once
        for gi in range(G):
            u = u_groups[gi]
            if u.dtype == acc:
                u.add_(x_keep[gi]).sub_(z_ref[:, None, :])
            else:
                u.copy_(u.to(acc).add_(x_keep[gi]).sub_(z_ref[:, None, :]))
            pad = self._pad_on(gi, u_groups[gi].device)
            if pad is not None:         # padded blocks keep zero duals
                u_groups[gi].index_fill_(1, pad, 0.0)
        return z_new, diffs, lls, trip_mat

    def _pad_on(self, gi: int, device) -> torch.Tensor | None:
        """Group gi's padded local blocks as ids on `device` (the host copy
        for host-resident duals)."""
        pad = self.pad_idx[gi]
        return pad if pad is None or pad.device == device \
            else self._pad_host[gi]

    # ------------------------------------------------------------------
    def run(self, z0: np.ndarray | None = None, *,
            u0: np.ndarray | None = None, start_iteration: int = 1,
            inner_eps0: float | None = None, mindiff0: float = 99999999.0,
            best_loglik0: float = -9999999.0,
            callback: Callable | None = None) -> AdmmResult:
        """Run the streaming ADMM loop.

        z0/u0/start_iteration/inner_eps0/mindiff0/best_loglik0 resume from a
        checkpoint (utils/checkpoint, or a JAX run's state through
        mlease_tpu_torch.convert), as AdmmTrainer.run. `callback(iteration=,
        z=, u=, diffs=, inner_eps=, logliks=)` fires per iteration with z
        (L, n) and u (L, nblocks, n) as tensors (on the device for device
        consensus, on the host otherwise)."""
        cfg = self.config
        dtype, dev = cfg.dtype, self.device
        L, n, G = len(self.lambdas), self.dim, len(self.groups)
        if cfg.regularizer not in (1, 2):
            raise ValueError("Only L1 and L2 regularization supported!")

        z_np = (np.zeros((L, n)) if z0 is None
                else np.broadcast_to(np.asarray(z0, np.float64),
                                     (L, n)).copy())
        parts = (1 if self.mesh is None
                 else axis_size(self.mesh, BLOCK_AXIS))
        u_np = [np.zeros((L, g.nblocks * parts, n)) for g in self.groups]
        if u0 is not None:
            u0 = np.asarray(u0, np.float64)
            off = 0
            for gi, real in enumerate(self.real_nblocks):
                u_np[gi][:, :real] = u0[:, off:off + real]
                off += real
        if self.mesh is not None:
            u_np = [block_sharding(self.mesh, 1).take(u) for u in u_np]
        z = torch.as_tensor(z_np, dtype=dtype, device=dev)
        if self._consensus_device:
            u_groups = [torch.as_tensor(u, dtype=dtype, device=dev)
                        for u in u_np]
        else:
            u_groups = [self._pin(torch.as_tensor(u, dtype=dtype))
                        for u in u_np]
        del u_np

        inner_eps = (cfg.liblinear_epsilon if inner_eps0 is None
                     else float(inner_eps0))
        mindiff = mindiff0
        best_loglik = best_loglik0
        best_z: torch.Tensor | None = None
        best_lambda: str | None = None
        loglik_history: list[dict] = []
        diff_history: list[dict] = []
        iter_times: list[float] = []
        solver_stats: list[dict] = []
        # per-iteration (G, 2) newton/cg counters per group
        self.trip_log: list[np.ndarray] = []
        converged = False
        t_start = time.monotonic()
        iteration = start_iteration - 1
        track_ll = self.test_arrays is not None and cfg.test_loglik_per_iter

        # iteration-0 loglik when warm-started (RegressionAdmmTrain.java:277-280)
        if z0 is not None and track_ll and start_iteration == 1:
            for lam, ll in zip(self.lambdas, self.sample_loglik(z)):
                loglik_history.append({"lambda": _lambda_key(lam), "iter": 0,
                                       "testLoglik": float(ll)})

        rho_base = torch.as_tensor(self.rhos, dtype=dtype, device=dev)
        rho_tab = _rho_table(self.rhos, cfg.num_iters, cfg, z0 is not None,
                             dev)
        run_id = profiling.new_run()
        for iteration in range(start_iteration, cfg.num_iters + 1):
            t_iter = time.monotonic()
            inner_eps = admm_math.inner_eps_schedule(
                inner_eps, iteration, mindiff,
                aggressive=cfg.aggressive_liblinear_epsilon_decay)
            rho_eff = rho_tab[iteration]

            # the span the device idle share of an iteration is read over
            # (chip_smoke.py phase 11), with the trainer's clock on
            with profiling.span("stream_iteration", run=run_id,
                                iteration=iteration), self.clock.active():
                self.clock.idle_stamp()
                z, diffs, lls, trip_mat = self._iterate(
                    z, u_groups, rho_eff, rho_base, inner_eps, track_ll)

            self.trip_log.append(trip_mat)
            trips = trip_mat.sum(axis=0)
            solver_stats.append({"newton_trips": int(trips[0]),
                                 "cg_trips": int(trips[1])})
            mindiff = float(diffs.min())
            maxdiff = float(diffs.max())
            diff_history.append({_lambda_key(l): float(d)
                                 for l, d in zip(self.lambdas, diffs)})
            iter_times.append(time.monotonic() - t_iter)
            logger.info(
                "stream iter %d: maxdiff=%g (%.2fs, %d newton / %d cg "
                "trips over %d groups)", iteration, maxdiff, iter_times[-1],
                int(trips[0]), int(trips[1]), G)

            # per-iteration sample loglik + best-model tracking
            # (RegressionAdmmTrain.java:766-845)
            iter_lls = None
            if track_ll:
                iter_lls = []
                for li, (lam, ll) in enumerate(zip(self.lambdas, lls)):
                    ll = float(ll)
                    entry = {"lambda": _lambda_key(lam), "iter": iteration,
                             "testLoglik": ll}
                    loglik_history.append(entry)
                    iter_lls.append(entry)
                    if ll > best_loglik:
                        best_loglik = ll
                        best_lambda = _lambda_key(lam)
                        best_z = z[li].clone()

            if callback is not None:
                callback(iteration=iteration, z=z,
                         u=self._global_u(u_groups), diffs=diffs,
                         inner_eps=inner_eps, logliks=iter_lls)

            if admm_math.should_stop(maxdiff, inner_eps, cfg.epsilon,
                                     cfg.inner_eps_floor):
                converged = True
                break

        with profiling.span("stream_epilogue", run=run_id):
            z_out = z.to(torch.float64).cpu().numpy()
            best_model = (None if best_z is None else LinearModel.from_dense(
                best_z.to(torch.float64).cpu().numpy(), self.vocab))
            u_full = self._global_u(u_groups).to(torch.float64).cpu()
            models = {_lambda_key(l): LinearModel.from_dense(z_out[i],
                                                             self.vocab)
                      for i, l in enumerate(self.lambdas)}
        return AdmmResult(models=models, best_model=best_model,
                          best_lambda=best_lambda, best_loglik=best_loglik,
                          iterations=iteration,
                          sample_loglik_history=loglik_history,
                          diff_history=diff_history, z=z_out,
                          u=u_full.numpy(), converged=converged,
                          iter_times=iter_times, solver_stats=solver_stats,
                          wall_time=time.monotonic() - t_start)


    def _global_u(self, u_groups) -> torch.Tensor:
        """The (L, nblocks, n) duals in block order: under a mesh each
        group's slices gathered over the ranks, its padding (a suffix of
        the group) dropped."""
        if self.mesh is not None:
            u_groups = [all_gather(u, self._group_comm, dim=1)
                        for u in u_groups]
        return torch.cat([u[:, :real] for u, real in zip(
            u_groups, self.real_nblocks)], dim=1)


def _to_head_dtype(head, hdt):
    """The dense head in its storage dtype: a numpy array where numpy has
    the type, a host torch.bfloat16 tensor otherwise."""
    np_hdt = _numpy_dtype(hdt)
    if isinstance(head, torch.Tensor):
        if np_hdt is not None:
            return head.to(hdt).numpy()
        return head if head.dtype == hdt else head.to(hdt)
    if np_hdt is not None:
        return head if head.dtype == np_hdt else np.asarray(head, np_hdt)
    return torch.from_numpy(np.ascontiguousarray(head)).to(hdt)
