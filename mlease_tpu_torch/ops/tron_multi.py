"""Multi-RHS TRON: the whole lambda path solved in one pass over the data.

Port of the lanes-major solver of mlease_tpu/ops/tron_multi.py: the same
algorithm (Tron.java:30-179 with the warm-start modification, run
independently per lambda lane), the same lock-step trip counting and the
same masked per-lane updates. All trust-region scalars (f, delta, ||g||,
accept/reject) are (L,) tensors. The JAX package's `lax.while_loop`s are
split into functions of a state (`MultiSolver`: the Newton init, one CG
trip, the Newton epilogue) whose counters stay on the device; `tron_multi`
runs them in host loops whose condition (`any(active)`) is read back once
per trip, and the trainers' device loops (train/admm.py::_SolveLoop, in
run(), the streaming trainer and run_fused) run the same functions inside
a CUDA graph that loops on the card (ops/device_loop.py).

Internally the state is lanes-major, (L, n) and (L, R); the public contract
is the JAX one, (n, L) in and (n, L) out. Each sorted sparse-tail reduce is
one call of `ops.segment_sum.segment_sum_gather`, the hand-written kernel on
the card that gathers, weights and reduces the tail into the pass's output
in place (no size gate: every sorted-tail reduce takes it). Xv gathers the
ELL row by row, each row summed in one order; X'v, its 2L pass and the
Hessian diagonal sum the ELL with K1 too, over the column-sorted copy of
its slots that every stacked problem carries (`with_column_copy`, made
once by `stack_blocks` and by the streaming trainer's shipped column
order): `index_add_`'s atomics would sum in another order on every run on
the card. On the card the ELL without that copy and a row-sorted tail
without its column-sorted one raise (`host_scatter_only`); on the CPU
they are `index_add_`'s, as XLA's scatter.

The dense head's products: a head stored in bfloat16 under a float32 solve,
on the card, takes the hand-written kernels of ops/head_pass.py (`takes`),
which read the stored head once a pass and widen it in registers; every
other head (float32, a bfloat16 solve, the CPU) is widened a block at a
time where its dtype is not the solve's and multiplied by cuBLAS
(`_widen`, `_head_gemm_xv`, `_head_t`). Each pass's head part runs inside
the span `head_pass` (ops/device_loop.py::device_span), and inside it
`head_fused` or `head_gemm` names the route; each K1 call runs inside
`tail_pass`, and a bfloat16 one inside `tail_bf16` too (K1's bf16 entry).

precondition="head_block" solves the dense-head curvature block exactly:
its (L, H, H) build is the weighted-Gram kernel of ops/gram.py with one
shared X and L weight vectors.

`blocks=B` solves the B blocks of a stacked problem (`stack_blocks`) as B
independent problems, the JAX package's `vmap(tron_multi)` over blocks:
every (lambda, block) pair has its own trust region, CG state and stop
rule, all run in lock-step over the same flat data (so K1's fused tail
reduces are the same calls). The solver state is (L, B, ·): every dot and
norm reduces over one block's segment of the coefficient axis, every row
sum over one block's rows, and a block whose own loop has ended keeps its
whole state, as a lane of `jax.vmap` over `lax.while_loop` does. B = 1 is
the flat-blocks solve: one joint trust region per lambda. With a dense head
and "head_block", each block's (L, H, H) head Gram is one K2 call on that
block's head (B calls per build).

The public pass functions (`xv`, `xtv`, `scores`, `fun`,
`grad_and_curvature`, `xtv_and_sqdiag`, `fun_grad_curvature`,
`grad_norm_at_zero`, `hv`, `hessian_diagonal`) take and return the JAX
package's lanes-minor layout, (n, L) and (R, L), around the lanes-major pass
the solver runs, and return the transpose of its result. A coefficient
operand (n, L) goes in as its transposed view (K1 gathers a lanes-minor V
in place); a row operand (R, L) goes in as a lanes-major copy, since the
dense head's X'v product on a transposed D takes another cuBLAS algorithm
and other bits (PERF.md). So each gives its solver pass's bits.

`group=` (a torch.distributed process group) is feature model
parallelism, the JAX package's `axis_name`: the coefficient axis is
column-sharded over the group's ranks (core/feature_shard.py, shard-local
ids), and the solve makes one all_reduce(SUM) of the partial scores per Xv
and of every dot, norm and prior term, where the JAX package psums them
(collectives.py). Every (L,) or (L, B) trust-region scalar is then the
same bits on every rank, so the ranks' lock-step loops take the
same trips. group=None is the single-shard solve, unchanged.

A bfloat16 solve keeps the data and the solver's vectors (W, G, D, the CG
directions) in bfloat16, as the JAX solver carries them, and sums in
float32 (`ops.segment_sum.accumulate_dtype`): the margins, the row losses,
the prior term and F stay float32 (a bfloat16 F moves in steps of 0.5 at
|F| about 100 and stalls the trust region), and so do the multi-RHS
solver's dots, norms and trust-region scalars (a bfloat16 ||g|| moves in
steps of 16 at the ctr-12m stop test's 2,600); every sum
over the data is float32, and a vector the solver keeps rounds to
bfloat16 once, after its sum. An operand that a bfloat16 kernel reads is
rounded first: K1's V (the gradient's coefficients, D * Xs) and the dense
head's GEMM, which cuBLAS accumulates in float32 and rounds once.
ops/objective.py (the lanes solve, the item solvers) follows the same
rule, its lanes' scalars in bfloat16 as the JAX package keeps them.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from mlease_tpu_torch.ops.device_loop import device_span
from mlease_tpu_torch.ops.gram import gram_batched
from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv, takes
from mlease_tpu_torch.ops.segment_sum import (accumulate_dtype,
                                              host_scatter_only,
                                              segment_sum_gather)
from mlease_tpu_torch.collectives import all_reduce

# Trust-region update constants (Tron.java:31-35), as in mlease_tpu/ops/tron.py
ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


class MultiProblem(NamedTuple):
    """One data block (or B blocks folded flat), L lambda-problems.

    Field meanings and shapes follow mlease_tpu/ops/tron_multi.py: in the
    flat-blocks form head_x keeps its (B, Rb, H) batch axis and every other
    id is offset into the stacked (B*R rows, B*n columns) space. tail_rows
    and tail_c_cols are non-decreasing (the segment ids of the two sorted
    tail reduces)."""

    indices: torch.Tensor        # (R, K) int32 (K may be 0 in hybrid mode)
    values: torch.Tensor         # (R, K)
    y: torch.Tensor              # (R,)
    weight: torch.Tensor         # (R,)
    offset: torch.Tensor         # (R,)
    prior_mean: torch.Tensor     # (n, L)
    prior_var_inv: torch.Tensor  # (n, L) or broadcastable to it
    head_x: torch.Tensor | None = None     # (R, H) | (B, Rb, H) flat-blocks
    head_ids: torch.Tensor | None = None   # (H,)   | (B*H,)     flat-blocks
    tail_rows: torch.Tensor | None = None  # (T,) sorted ascending
    tail_cols: torch.Tensor | None = None  # (T,)
    tail_vals: torch.Tensor | None = None  # (T,)
    tail_c_rows: torch.Tensor | None = None  # (T,)
    tail_c_cols: torch.Tensor | None = None  # (T,) sorted ascending
    tail_c_vals: torch.Tensor | None = None  # (T,)
    # the column-sorted copy of the ELL slots, padding included (X'v's K1
    # stream; `with_column_copy`): int32 row and column ids, the values
    csc_rows: torch.Tensor | None = None   # (R*K,)
    csc_cols: torch.Tensor | None = None   # (R*K,) sorted ascending
    csc_vals: torch.Tensor | None = None   # (R*K,)

    @property
    def dim(self) -> int:
        return self.prior_mean.shape[0]

    @property
    def n_rhs(self) -> int:
        return self.prior_mean.shape[1]


def _check_ids(ids: torch.Tensor, bound: int, name: str,
               is_sorted: bool = False) -> None:
    """The tail reduces need ids inside [0, bound) (the kernel gathers
    without a bounds check), and segment ids truly non-decreasing."""
    if ids.numel() == 0:
        return
    bad = torch.stack([(ids[1:] < ids[:-1]).any() & is_sorted,
                       ids.min() < 0, ids.max() >= bound]).cpu()
    if bool(bad[0]):
        raise ValueError(f"{name} must be non-decreasing (sorted tail)")
    if bool(bad[1]) or bool(bad[2]):
        raise ValueError(f"{name} holds ids outside [0, {bound})")


def with_prior(prob: MultiProblem, prior_mean: torch.Tensor,
               rho_eff: torch.Tensor) -> MultiProblem:
    """Set the flat problem's Gaussian prior: prior_mean (L, B, n) -> the
    stacked (B*n, L) mean; rho_eff (L,) the per-lane prior precision."""
    L, B, n = prior_mean.shape
    return prob._replace(
        prior_mean=prior_mean.permute(1, 2, 0).reshape(B * n, L),
        prior_var_inv=torch.ones((B * n, 1), dtype=prior_mean.dtype,
                                 device=prior_mean.device) * rho_eff[None, :])


# Stacked row and column ids are int32 (K1 reads int32 segment ids): B
# blocks of R rows and n columns fold into one problem only while B*n and
# B*R stay below this bound. Past it the flat solve is left (solver_mode)
# and a per-block solve runs its blocks in consecutive sub-stacks.
STACK_ID_BOUND = 2**31


def stack_fits(nblocks: int, n: int, rows: int) -> bool:
    """B blocks of `rows` rows and n columns stack inside the bound (the
    JAX package's `_use_flat` int32 terms)."""
    return nblocks * n < STACK_ID_BOUND and nblocks * rows < STACK_ID_BOUND


def substack_ranges(nblocks: int, n: int, rows: int) -> list[tuple[int, int]]:
    """Consecutive block ranges [b0, b1) covering the B blocks, each of as
    many blocks as keep its stacked ids inside the bound (one range when
    all B fit)."""
    per = min((STACK_ID_BOUND - 1) // max(n, 1),
              (STACK_ID_BOUND - 1) // max(rows, 1))
    if per < 1:
        raise ValueError(f"one block of {rows} rows and {n} columns has ids "
                         f"past int32")
    return [(b, min(b + per, nblocks)) for b in range(0, nblocks, per)]


class SubStacks(NamedTuple):
    """A per-block solve's blocks as consecutive sub-stacks: `probs[k]` the
    stacked problem of blocks ranges[k] = [b0, b1), its ids offset from its
    own first block. The blocks share nothing in a per-block solve, so
    solving the sub-stacks one after another is the solve of all B."""

    probs: tuple
    ranges: tuple


def stack_substacks(indices, values, y, weight, offset, head, prior_mean,
                    rho_eff):
    """stack_blocks of the B blocks when their ids fit int32, else a
    SubStacks of one stack_blocks per substack_ranges range (every (B, ...)
    argument cut to its blocks; head_ids, shared, kept)."""
    B, R, _ = indices.shape
    ranges = substack_ranges(B, prior_mean.shape[2], R)
    if len(ranges) == 1:
        return stack_blocks(indices, values, y, weight, offset, head,
                            prior_mean, rho_eff)

    def cut(a, b0, b1):
        return None if a is None else a[b0:b1]
    return SubStacks(tuple(
        stack_blocks(indices[b0:b1], values[b0:b1], y[b0:b1],
                     weight[b0:b1], offset[b0:b1],
                     tuple(a if i == 1 else cut(a, b0, b1)
                           for i, a in enumerate(head)),
                     prior_mean[:, b0:b1], rho_eff)
        for b0, b1 in ranges), tuple(ranges))


def substacks_of(prob, nblocks: int) -> list:
    """[(problem, (b0, b1))] of each sub-stack of a SubStacks, or of the
    one stacked problem of all `nblocks` blocks."""
    if isinstance(prob, SubStacks):
        return list(zip(prob.probs, prob.ranges))
    return [(prob, (0, nblocks))]


def join_block_results(results) -> "MultiTronResult":
    """The per-block results of consecutive sub-stacks as one: w and the
    per-block fields joined in block order, block_trips joined, the
    lock-step trip counts the maxima over the sub-stacks."""
    results = list(results)
    if len(results) == 1:
        return results[0]
    L = results[0].w.shape[1]

    def cat(f):
        return torch.cat([getattr(r, f).reshape(L, -1) for r in results], 1)
    return MultiTronResult(
        w=torch.cat([r.w for r in results]), f=cat("f"), gnorm=cat("gnorm"),
        iterations=cat("iterations"), converged=cat("converged"),
        newton_trips=max(r.newton_trips for r in results),
        cg_trips=max(r.cg_trips for r in results),
        block_trips=np.concatenate([r.block_trips for r in results]))


def stack_blocks(indices, values, y, weight, offset, head,
                 prior_mean, rho_eff) -> MultiProblem:
    """Fold B batched blocks into ONE flat MultiProblem (flat-blocks form).

    indices/values are (B, R, K); y/weight/offset (B, R); `head` the 8-tuple
    of hybrid arrays (all (B, ...) or None); prior_mean (L, B, n); rho_eff
    (L,). Per-block sorted tails stay globally sorted because block-major
    offsets are monotone; this is checked here, once, together with the id
    ranges of both streams, since the sorted-stream kernel relies on both.
    The ELL slots get their column-sorted copy (`with_column_copy`), in
    block order for the same reason."""
    (head_x, head_ids, t_rows, t_cols, t_vals,
     tc_rows, tc_cols, tc_vals) = head
    B, R, K = indices.shape
    n = prior_mean.shape[2]
    if not stack_fits(B, n, R):
        raise ValueError("stacked row and column ids must fit int32")
    dev = indices.device
    boffs_n = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * n
    kw = {}
    if head_x is not None:
        boffs_r = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * R
        kw = dict(
            head_x=head_x,
            head_ids=(head_ids[None, :] + boffs_n).reshape(-1),
            tail_rows=(t_rows + boffs_r).reshape(-1),
            tail_cols=(t_cols + boffs_n).reshape(-1),
            tail_vals=t_vals.reshape(-1))
        _check_ids(kw["tail_rows"], B * R, "tail_rows", is_sorted=True)
        _check_ids(kw["tail_cols"], B * n, "tail_cols")
        if tc_cols is not None:
            kw.update(
                tail_c_rows=(tc_rows + boffs_r).reshape(-1),
                tail_c_cols=(tc_cols + boffs_n).reshape(-1),
                tail_c_vals=tc_vals.reshape(-1))
            _check_ids(kw["tail_c_cols"], B * n, "tail_c_cols",
                       is_sorted=True)
            _check_ids(kw["tail_c_rows"], B * R, "tail_c_rows")
    prob = MultiProblem(
        indices=(indices + boffs_n[..., None]).reshape(B * R, K),
        values=values.reshape(B * R, K),
        y=y.reshape(-1), weight=weight.reshape(-1),
        offset=offset.reshape(-1),
        prior_mean=None, prior_var_inv=None, **kw)
    return with_prior(with_column_copy(prob), prior_mean, rho_eff)


def column_copy(indices: torch.Tensor, values: torch.Tensor,
                order: torch.Tensor | None = None):
    """(rows, cols, vals) of the ELL slots (indices / values (R, K), or
    flat with K given by a 2-D indices) in column order, padding slots
    included: int32 ids, the stable sort by column id (a row's slots and
    rows of one column keep the ELL's row-major order) or `order`, that
    sort made elsewhere (int32 or int64 positions in the flat slots)."""
    K = indices.shape[-1]
    cols = indices.reshape(-1)
    if order is None:
        order = torch.sort(cols.to(torch.int32), stable=True).indices
    return ((order // K).to(torch.int32),
            cols.index_select(0, order).to(torch.int32),
            values.reshape(-1).index_select(0, order))


def with_column_copy(prob: MultiProblem) -> MultiProblem:
    """prob with the column-sorted copy of its ELL slots (`column_copy`;
    none without ELL slots): X'v, its 2L pass and the Hessian diagonal sum
    the ELL over it with K1, in one fixed order, where `index_add_`'s
    atomics would sum in another order on every run on the card. Xv keeps
    the ELL (a row's gather sums in one order). Made once per problem:
    4 + 4 bytes of ids and a value a slot."""
    if prob.indices.shape[-1] == 0:
        return prob
    rows, cols, vals = column_copy(prob.indices, prob.values)
    return prob._replace(csc_rows=rows, csc_cols=cols, csc_vals=vals)


def ell_as_sorted_tails(prob: MultiProblem) -> MultiProblem:
    """prob (ELL only, no head) with its ELL entries, padding slots
    included, as the row-sorted and the column-sorted tail (int32 ids; the
    ELL's row-major order is row-sorted, the column order its column
    copy): Xv and X'v then both sum them with K1, in one fixed order (the
    naive trainer's stacked keys, whose device loop is held to the
    host-driven solve bit for bit). A padding slot adds 0 * v."""
    R, K = prob.indices.shape
    if prob.csc_cols is None:
        prob = with_column_copy(prob)
    cols = prob.indices.reshape(-1).to(torch.int32)
    rows = torch.arange(R * K, device=cols.device) // K
    return prob._replace(
        indices=prob.indices[:, :0], values=prob.values[:, :0],
        tail_rows=rows.to(torch.int32), tail_cols=cols,
        tail_vals=prob.values.reshape(-1), tail_c_rows=prob.csc_rows,
        tail_c_cols=prob.csc_cols, tail_c_vals=prob.csc_vals,
        csc_rows=None, csc_cols=None, csc_vals=None)


# ---------------------------------------------------------------------------
# Lanes-major passes: V / W / D are (L, ·), prob priors are (L, n)
# ---------------------------------------------------------------------------

def _widen(hb: torch.Tensor, dtype, square: bool = False) -> torch.Tensor:
    """One block's head in the compute dtype (head.dtype=bfloat16 stores it
    at half width), squared elementwise when asked, in the storage dtype as
    the JAX package squares it (the square only feeds the Jacobi
    diagonal). The flat-blocks passes call this one block at a time, so a
    narrow head is never widened whole: the transient is one block's
    (Rb, H) in the compute dtype, not the (B, Rb, H) head."""
    if square:
        hb = hb * hb
    return hb if hb.dtype == dtype else hb.to(dtype)


def _head_t(hx: torch.Tensor, D: torch.Tensor,
            square: bool = False) -> torch.Tensor:
    """Transposed head product: (L, R) -> (L, H) or, flat-blocks,
    (L, B*Rb) -> (L, B*H) (einsum "brh,lbr->lbh"), with the head squared
    elementwise when `square`. Flat-blocks takes one (L, Rb) @ (Rb, H)
    product per block: as one batched bmm this long-K, tiny-output product
    ran ~15x slower on an H100 (tools/torch_head_product_probe.py)."""
    if hx.dim() == 3:
        B, Rb, H = hx.shape
        Db = D.reshape(D.shape[0], B, Rb)
        return torch.cat([Db[:, b] @ _widen(hx[b], D.dtype, square)
                          for b in range(B)], dim=1)
    return D @ _widen(hx, D.dtype, square)


def _head_gemm_xv(hx: torch.Tensor, hw: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The head's scores added into `out` (L, R) by torch's products: hw
    (L, H) or, flat-blocks, (L, B*H) against a head of V's dtype in one
    batched bmm, a narrow head widened a block at a time."""
    L, R = out.shape
    if hx.dim() == 3 and hx.dtype == hw.dtype:          # flat-blocks head
        B, Rb, H = hx.shape
        prod = torch.bmm(hx, hw.reshape(L, B, H).permute(1, 2, 0))
        return out + prod.permute(2, 0, 1).reshape(L, R)   # (B, Rb, L)
    if hx.dim() == 3:                                   # narrow head: by block
        B, Rb, H = hx.shape
        hwb = hw.reshape(L, B, H)
        outb = out.view(L, B, Rb)               # out is this pass's own
        for b in range(B):
            outb[:, b] += hwb[:, b] @ _widen(hx[b], hw.dtype).T
        return out
    return out + hw @ _widen(hx, hw.dtype).T


@contextlib.contextmanager
def _tail_span(vals: torch.Tensor):
    """The span `tail_pass` around a pass's K1 call, and inside it
    `tail_bf16` where K1 reads bfloat16 values (its bf16 entry)."""
    with device_span("tail_pass"):
        if vals.dtype != torch.bfloat16:
            yield
            return
        with device_span("tail_bf16"):
            yield


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Row-space partials summed over the feature shards of `group`
    (None: one shard, the identity)."""
    return x if group is None else all_reduce(x, "sum", group)


def _xv_lm(prob: MultiProblem, V: torch.Tensor,
           group=None) -> torch.Tensor:
    """(L, n) -> (L, R) scores in the accumulate type (float32 for a
    bfloat16 V: the margins stay float32, products of the data as stored
    and the widened V, the head's GEMM accumulated in float32 by cuBLAS and
    rounded once, the tail's K1 sums added into float32 scores; a bfloat16
    head under a float32 V goes through the kernels of ops/head_pass.py,
    which add its float32 dots into the scores); under
    feature sharding each rank computes its columns' partial scores and the
    all_reduce assembles full rows (the only collective of the matvec
    pair: X'v is column-local)."""
    R = prob.y.shape[0]
    L = V.shape[0]
    acc = accumulate_dtype(V.dtype)
    if prob.indices.shape[-1] > 0:
        out = (prob.values[None] * V.to(acc)[:, prob.indices]).sum(-1)
    else:
        out = torch.zeros((L, R), dtype=acc, device=V.device)
    if prob.head_x is not None:
        with device_span("head_pass"):
            hx = prob.head_x
            hw = V[:, prob.head_ids]                    # (L, H) | (L, B*H)
            if takes(hx, V.dtype):                      # bf16 head, card
                with device_span("head_fused"):
                    head_xv(hx, hw, out)
            else:
                with device_span("head_gemm"):
                    out = _head_gemm_xv(hx, hw, out)
    if prob.tail_cols is not None:
        with _tail_span(prob.tail_vals):
            segment_sum_gather(prob.tail_vals, V, prob.tail_cols,
                               prob.tail_rows, R, out=out)
    return _psum(out, group)


def _xtv_lm(prob: MultiProblem, D: torch.Tensor) -> torch.Tensor:
    """(L, R) -> (L, n) accumulation, in the accumulate type (for a
    bfloat16 D every sum in float32, K1's sums added into the float32
    sums; the caller rounds once): the ELL's column copy, the head, the
    column-sorted tail, in that order."""
    n = prob.prior_mean.shape[-1]
    L = D.shape[0]
    acc = accumulate_dtype(D.dtype)
    out = torch.zeros((L, n), dtype=acc, device=D.device)
    if prob.csc_cols is not None:
        with _tail_span(prob.csc_vals):
            segment_sum_gather(prob.csc_vals, D, prob.csc_rows,
                               prob.csc_cols, n, out=out)
    elif prob.indices.shape[-1] > 0:
        host_scatter_only(D, "X'v over the ELL")
        out.index_add_(1, prob.indices.reshape(-1),
                       (prob.values[None] * D.to(acc)[:, :, None])
                       .reshape(L, -1))
    if prob.head_x is not None:
        with device_span("head_pass"):
            if takes(prob.head_x, D.dtype):
                with device_span("head_fused"):
                    head_xtv(prob.head_x, D, prob.head_ids, out)
            else:
                with device_span("head_gemm"):
                    out.index_add_(1, prob.head_ids,
                                   _head_t(prob.head_x, D).to(acc))
    if prob.tail_c_cols is not None:
        with _tail_span(prob.tail_c_vals):
            segment_sum_gather(prob.tail_c_vals, D, prob.tail_c_rows,
                               prob.tail_c_cols, n, out=out)
    elif prob.tail_cols is not None:
        host_scatter_only(D, "X'v over a row-sorted tail")
        out = out + torch.zeros_like(out).index_add_(
            1, prob.tail_cols,
            prob.tail_vals[None, :] * D.to(acc)[:, prob.tail_rows])
    return out


def _xtv_and_sqdiag_lm(prob: MultiProblem, C: torch.Tensor,
                       Dm: torch.Tensor):
    """(X'C, (X∘X)'Dm) with the 2L lanes stacked, so every nonzero's id and
    value are read once for both; in the accumulate type, as `_xtv_lm`."""
    n = prob.prior_mean.shape[-1]
    L = C.shape[0]
    acc = accumulate_dtype(C.dtype)
    out = torch.zeros((2 * L, n), dtype=acc, device=C.device)
    CD = torch.cat([C, Dm])
    if prob.csc_cols is not None:
        with _tail_span(prob.csc_vals):
            segment_sum_gather(prob.csc_vals, CD, prob.csc_rows,
                               prob.csc_cols, n, out=out, square_from=L)
    elif prob.indices.shape[-1] > 0:
        host_scatter_only(C, "X'v over the ELL")
        v = prob.values[None]
        contrib = torch.cat([v * C[:, :, None], (v * v) * Dm[:, :, None]])
        out.index_add_(1, prob.indices.reshape(-1),
                       contrib.reshape(2 * L, -1).to(acc))
    if prob.head_x is not None:
        hx = prob.head_x
        with device_span("head_pass"):
            if takes(hx, C.dtype):              # the head read once for 2L
                with device_span("head_fused"):
                    head_xtv(hx, CD, prob.head_ids, out, square_from=L)
            else:
                with device_span("head_gemm"):
                    out.index_add_(1, prob.head_ids, torch.cat(
                        [_head_t(hx, C),
                         _head_t(hx, Dm, square=True)]).to(acc))
    if prob.tail_c_cols is not None:
        with _tail_span(prob.tail_c_vals):
            segment_sum_gather(prob.tail_c_vals, CD, prob.tail_c_rows,
                               prob.tail_c_cols, n, out=out, square_from=L)
    elif prob.tail_cols is not None:
        host_scatter_only(C, "X'v over a row-sorted tail")
        tv = prob.tail_vals[None, :]
        rows = CD[:, prob.tail_rows]
        contrib = torch.cat([tv * rows[:L], (tv * tv) * rows[L:]])
        out = out + torch.zeros_like(out).index_add_(1, prob.tail_cols,
                                                     contrib.to(acc))
    return out[:L], out[L:]


def _softplus_neg(yz: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-yz)), exactly as jnp.logaddexp(0, -yz)."""
    return torch.logaddexp(yz.new_zeros(()), -yz)


def _seg(a: torch.Tensor, blocks: int) -> torch.Tensor:
    """(L, B*m) -> (L, B, m): one block's segment per middle index."""
    return a.view(a.shape[0], blocks, -1)


def _fun_grad_curvature_lm(prob: MultiProblem, W: torch.Tensor,
                           with_diag: bool = False,
                           blocks: int | None = None, group=None):
    """Objective + gradient + curvature (+ Jacobi diagonal) sharing ONE
    scores pass. F is (L,), or (L, B) per block with `blocks=B` (the rows
    and columns of a stacked problem in B equal segments). Under feature
    sharding the prior term of F is summed over the shards. For a bfloat16
    W (the module docstring's rule) the margins, the losses, the prior
    term and F are float32; the gradient's coefficients and the curvature,
    which K1 and the head's GEMM read, round to W's type first, and G and
    the diagonal round once after their float32 sums."""
    yz = prob.y[None, :] * (_xv_lm(prob, W, group) + prob.offset[None, :])
    dw = W.to(yz.dtype) - prob.prior_mean
    loss = prob.weight[None, :] * _softplus_neg(yz)
    quad = dw * dw * prob.prior_var_inv
    if blocks is None:
        F = loss.sum(1) + 0.5 * _psum(quad.sum(1), group)
    else:
        F = _seg(loss, blocks).sum(-1) + 0.5 * _psum(
            _seg(quad, blocks).sum(-1), group)
    p = torch.sigmoid(yz)
    coeff = (prob.weight[None, :] * (p - 1.0) * prob.y[None, :]).to(W.dtype)
    Dm = (prob.weight[None, :] * p * (1.0 - p)).to(W.dtype)
    if with_diag:
        Gd, Hd = _xtv_and_sqdiag_lm(prob, coeff, Dm)
        return (F, (Gd + dw * prob.prior_var_inv).to(W.dtype), Dm,
                (Hd + prob.prior_var_inv).to(W.dtype))
    G = (_xtv_lm(prob, coeff) + dw * prob.prior_var_inv).to(W.dtype)
    return F, G, Dm


def _grad_at_zero_lm(prob: MultiProblem, n_rhs: int) -> torch.Tensor:
    """The gradient at W=0 per lane in one X'v pass (Xv(0) == 0 exactly)."""
    dtype = prob.prior_mean.dtype
    yz = prob.y[None, :] * prob.offset[None, :].expand(
        n_rhs, prob.y.shape[0]).to(accumulate_dtype(dtype))
    p = torch.sigmoid(yz)
    coeff = (prob.weight[None, :] * (p - 1.0) * prob.y[None, :]).to(dtype)
    return (_xtv_lm(prob, coeff)
            - prob.prior_mean * prob.prior_var_inv).to(dtype)


def _grad_norm_at_zero_lm(prob: MultiProblem, n_rhs: int,
                          group=None) -> torch.Tensor:
    """||grad at W=0|| per lane in one X'v pass (Xv(0) == 0 exactly), in
    the problem's dtype (a bfloat16 norm, summed in float32, rounds once:
    the solver keeps its own in float32)."""
    return _norm_lm(_grad_at_zero_lm(prob, n_rhs), group).to(
        prob.prior_mean.dtype)


def _hv_lm(prob: MultiProblem, Dm: torch.Tensor,
           S: torch.Tensor, group=None) -> torch.Tensor:
    return (_xtv_lm(prob, (Dm * _xv_lm(prob, S, group)).to(S.dtype))
            + S * prob.prior_var_inv).to(S.dtype)


def _hessian_diagonal_lm(prob: MultiProblem, Dm: torch.Tensor
                         ) -> torch.Tensor:
    """diag(H) per lane, (L, R) -> (L, n) in the accumulate type: (X∘X)'Dm,
    summed as the second half of `_xtv_and_sqdiag_lm` sums it (the tail one
    K1 call with every lane's weight squared), plus the prior precision,
    added last as `_fun_grad_curvature_lm` adds it to its diagonal."""
    n = prob.prior_mean.shape[-1]
    L = Dm.shape[0]
    acc = accumulate_dtype(Dm.dtype)
    out = torch.zeros((L, n), dtype=acc, device=Dm.device)
    if prob.csc_cols is not None:
        segment_sum_gather(prob.csc_vals, Dm, prob.csc_rows, prob.csc_cols,
                           n, out=out, square_from=0)
    elif prob.indices.shape[-1] > 0:
        host_scatter_only(Dm, "X'v over the ELL")
        v = prob.values[None]
        out.index_add_(1, prob.indices.reshape(-1),
                       ((v * v) * Dm[:, :, None]).reshape(L, -1).to(acc))
    if takes(prob.head_x, Dm.dtype):
        head_xtv(prob.head_x, Dm, prob.head_ids, out, square_from=0)
    elif prob.head_x is not None:
        out.index_add_(1, prob.head_ids,
                       _head_t(prob.head_x, Dm, square=True).to(acc))
    if prob.tail_c_cols is not None:
        segment_sum_gather(prob.tail_c_vals, Dm, prob.tail_c_rows,
                           prob.tail_c_cols, n, out=out, square_from=0)
    elif prob.tail_cols is not None:
        host_scatter_only(Dm, "X'v over a row-sorted tail")
        tv = prob.tail_vals[None, :]
        out = out + torch.zeros_like(out).index_add_(
            1, prob.tail_cols, ((tv * tv) * Dm[:, prob.tail_rows]).to(acc))
    return out + prob.prior_var_inv


def _dot_lm(a, b, group=None):
    """Per-lane dot over the last axis: (L, n) -> (L,), (L, B, n) -> (L, B);
    summed over the feature shards of `group`. In the accumulate type: a
    bfloat16 solve's dots, norms and the trust-region scalars made of them
    stay float32, as F does (a bfloat16 norm near the stop test's
    tolerance moves in steps of 0.4-0.8%)."""
    acc = accumulate_dtype(a.dtype)
    return _psum((a.to(acc) * b.to(acc)).sum(-1), group)


def _norm_lm(a, group=None):
    return torch.sqrt(_dot_lm(a, a, group))


class HeadBlockPrecond(NamedTuple):
    """M = (exact dense-head Hessian block) + (Jacobi diagonal on the tail).

    On power-law data the head columns carry most of the curvature mass, so
    preconditioning CG with the head block solved exactly (one (L, H, H)
    Cholesky per lane and block per Newton trip) plus the Jacobi diagonal
    elsewhere cuts CG trips against the diagonal alone. Any SPD M preserves
    TRON's convergence guarantees; the outer ||g|| stop rule is unchanged.
    Lanes-major, like the rest of the solver's state (the JAX package keeps
    diag as (n, L))."""

    chol: torch.Tensor       # (L, H, H) lower Cholesky factors per lane, or
                             # (L, B, H, H) per lane and block (a per-block
                             # head (B, Rb, H))
    diag: torch.Tensor       # (L, n) Jacobi diagonal; entries at head_ids
                             # are set to 1 and overridden by the block solve
    head_mask: torch.Tensor  # (1, n) 1.0 at head coordinates
    head_ids: torch.Tensor   # (H,) | (B*H,) stacked


def _gram_head(hb: torch.Tensor, dtype) -> torch.Tensor:
    """One block's head as K2 takes it: a bfloat16 head as stored when the
    solve runs in float32 (K2's bf16-in route accumulates in float32, and
    the head block only shapes a preconditioner: the JAX package builds it
    in the TPU's bf16 matrix-unit precision); widened otherwise."""
    if hb.dtype == torch.bfloat16 and dtype == torch.float32:
        return hb
    return _widen(hb, dtype)


def build_head_precond(prob: MultiProblem, Dm: torch.Tensor,
                       Hdiag: torch.Tensor) -> HeadBlockPrecond:
    """Head block A_l = head_x' diag(Dm_l) head_x + diag(pvi_head_l), with
    prob's priors, Dm (L, R) and Hdiag (L, n) lanes-major; for a per-block
    head (B, Rb, H), one such block per lane and block, from that block's
    rows of Dm and its head columns.

    The build is the weighted-Gram kernel with the head shared by the L
    lanes, one call per block, in the solve's own type (a float32 solve
    gives K2 a bfloat16 head as it is stored); the Cholesky runs in
    float32. Hdiag is the full Jacobi diagonal of the fused f/g/D + diag
    pass (its head entries are replaced, not reused). A grouped call (every
    block's X in one launch) would save only launches: at the ctr-12m
    shape one call is about 2 ms of work (PERF.md)."""
    dtype = Hdiag.dtype
    L = Hdiag.shape[0]
    ids = prob.head_ids.long()
    pvi_head = prob.prior_var_inv[:, ids]
    hx = prob.head_x
    if hx.dim() == 2:
        A = gram_batched(_gram_head(hx, dtype), Dm, pvi_head)
    else:
        B, Rb, H = hx.shape
        Dmb = Dm.view(L, B, Rb)
        pvb = pvi_head.view(L, B, H)
        A = torch.stack([gram_batched(_gram_head(hx[b], dtype), Dmb[:, b],
                                      pvb[:, b]) for b in range(B)], dim=1)
    # row-major, as run_fused's static copy of it is: the triangular
    # solves' rounding follows the factor's layout (cholesky_ex returns
    # each factor column-major)
    chol = torch.linalg.cholesky_ex(A.to(torch.float32))[0].to(
        dtype).contiguous()
    head_mask = torch.zeros((1, Hdiag.shape[1]), dtype=dtype,
                            device=Hdiag.device)
    head_mask.index_fill_(1, ids, 1.0)     # no host value: graph-safe
    diag = torch.where(head_mask > 0, torch.ones_like(Hdiag),
                       torch.clamp(Hdiag, min=1e-12))
    return HeadBlockPrecond(chol=chol, diag=diag, head_mask=head_mask,
                            head_ids=ids)


def _head_solve(pc: HeadBlockPrecond, r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r, (L, n): two triangular solves with the Cholesky factor on
    the head coordinates, a divide on the tail. Not cholesky_solve: on the
    card torch gives a batched cholesky_solve to MAGMA, which allocates
    inside the call and so cannot run inside AdmmTrainer.run_fused's CUDA
    graphs; the triangular solves are cuBLAS's trsm. A bfloat16 solve
    widens the factor to float32 and rounds the result: torch has no
    bfloat16 triangular solve on the CPU or the card."""
    chol = pc.chol.to(accumulate_dtype(pc.chol.dtype))
    rh = r[:, pc.head_ids].view(*chol.shape[:-1], 1).to(chol.dtype)
    y = torch.linalg.solve_triangular(chol, rh, upper=False)
    sol = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    out = r / pc.diag
    out[:, pc.head_ids] = sol.reshape(r.shape[0], -1).to(r.dtype)
    return out


def _head_apply(pc: HeadBlockPrecond, v: torch.Tensor) -> torch.Tensor:
    """M v, (L, n) (for the M-norm trust-region dots; a bfloat16 factor
    takes v's head coordinates rounded to bfloat16)."""
    vh = v[:, pc.head_ids].view(*pc.chol.shape[:-1], 1).to(pc.chol.dtype)
    Av = pc.chol @ (pc.chol.transpose(-1, -2) @ vh)
    out = v * pc.diag * (1.0 - pc.head_mask)
    out[:, pc.head_ids] = Av.reshape(v.shape[0], -1).to(out.dtype)
    return out


class MultiTronResult(NamedTuple):
    w: torch.Tensor            # (n, L)
    f: torch.Tensor            # (L,), or (L, B) with blocks=B > 1
    gnorm: torch.Tensor        # (L,) | (L, B)
    iterations: torch.Tensor   # (L,) | (L, B) accepted Newton steps
    converged: torch.Tensor    # (L,) | (L, B)
    # lock-step loop-trip counters: every trip is a full pass over the
    # data serving all lanes, however many lanes are still active
    newton_trips: int = 0
    cg_trips: int = 0
    # (B, 2) per block: the Newton and CG trips of that block's own loops,
    # the counters of the JAX package's vmap over blocks (equal to the two
    # above when B = 1)
    block_trips: np.ndarray | None = None


def _safe_div(num, den, ok):
    """num / den where `ok`, else 0 (jnp.where(ok, num/where(ok,den,1), 0))."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


class NewtonState(NamedTuple):
    """The Newton loop's carried state (Tron.java:30-124 per lane), every
    field a tensor: W, G, the Jacobi M (L, B, n); F, delta, gnorm, gnorm1,
    eps, it, active (L, B); Dm (L, R); the counters block_nt, block_cg (B,)
    and trips, cg_trips (0-d). M is None for the reference CG and a
    HeadBlockPrecond for "head_block"."""

    W: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    Dm: torch.Tensor
    M: torch.Tensor | HeadBlockPrecond | None
    delta: torch.Tensor
    gnorm: torch.Tensor
    gnorm1: torch.Tensor
    eps: torch.Tensor
    it: torch.Tensor          # (L, B) int32: accepted Newton steps + 1
    active: torch.Tensor
    block_nt: torch.Tensor
    block_cg: torch.Tensor
    trips: torch.Tensor
    cg_trips: torch.Tensor


class CgState(NamedTuple):
    """One Newton trip's truncated-CG state (Tron.java:126-179): s, r, z, d
    (L, B, n); rz, cgtol, done (L, B); it (0-d, the trip's CG trips so far);
    block_it (B,) per block; running (1, B) the blocks whose Newton loop
    runs this trip (the others' lanes start done and hold nothing open)."""

    s: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    d: torch.Tensor
    rz: torch.Tensor
    cgtol: torch.Tensor
    done: torch.Tensor
    it: torch.Tensor
    block_it: torch.Tensor
    running: torch.Tensor


def lanes_major(prob: MultiProblem) -> MultiProblem:
    """prob with its (n, L) priors as the solver's (L, n) lanes-major
    tensors: one transpose of each per solve."""
    return prob._replace(
        prior_mean=prob.prior_mean.T.contiguous(),
        prior_var_inv=torch.broadcast_to(
            prob.prior_var_inv, prob.prior_mean.shape).T.contiguous())


# ---------------------------------------------------------------------------
# The public passes, lanes-minor as in the JAX package: V / W / S / G (n, L),
# C / Dm / scores (R, L), prob's priors (n, L) or broadcastable to it
# ---------------------------------------------------------------------------
#
# Each takes `group` where the JAX function takes `axis_name`. Vectors come
# back in their input's dtype, rounded once after the float32 sums of a
# bfloat16 call; F stays in the accumulate type (float32 for bfloat16), as
# the solver keeps it. Coefficient operands go in as transposed views, row
# operands as lanes-major copies (`_rows`; the module docstring says why).

def _rows(D: torch.Tensor) -> torch.Tensor:
    """An (R, L) row operand as the (L, R) lanes-major tensor the solver's
    passes take."""
    return D.T.contiguous()


def xv(prob: MultiProblem, V: torch.Tensor, group=None) -> torch.Tensor:
    """(n, L) -> (R, L) scores of every lane in one data pass; under feature
    sharding the partial scores summed over the shards of `group`."""
    return _xv_lm(lanes_major(prob), V.T, group).T.to(V.dtype)


def xtv(prob: MultiProblem, Dm: torch.Tensor) -> torch.Tensor:
    """(R, L) -> (n, L) accumulation of every lane in one pass."""
    return _xtv_lm(lanes_major(prob), _rows(Dm)).T.to(Dm.dtype)


def scores(prob: MultiProblem, W: torch.Tensor, group=None) -> torch.Tensor:
    """xv(prob, W) + offset, (R, L), rounded once."""
    return (_xv_lm(lanes_major(prob), W.T, group)
            + prob.offset[None, :]).T.to(W.dtype)


def fun(prob: MultiProblem, W: torch.Tensor, group=None) -> torch.Tensor:
    """(L,) objective values from one scores pass (float32 for a bfloat16
    W); under feature sharding the prior term is summed over the shards.
    The same operations as the F of `fun_grad_curvature`."""
    lm = lanes_major(prob)
    Wl = W.T
    yz = lm.y[None, :] * (_xv_lm(lm, Wl, group) + lm.offset[None, :])
    dw = Wl.to(yz.dtype) - lm.prior_mean
    return ((lm.weight[None, :] * _softplus_neg(yz)).sum(1)
            + 0.5 * _psum((dw * dw * lm.prior_var_inv).sum(1), group))


def grad_and_curvature(prob: MultiProblem, W: torch.Tensor, group=None):
    """(G, Dm), both (·, L) in W's dtype: the gradient (n, L) and the
    curvature weights (R, L)."""
    _F, G, Dm = _fun_grad_curvature_lm(lanes_major(prob), W.T, group=group)
    return G.T, Dm.T


def xtv_and_sqdiag(prob: MultiProblem, C: torch.Tensor, Dm: torch.Tensor):
    """(X'C, (X∘X)'Dm), each (n, L), with the 2L lanes in one pass (one K1
    call on a column-sorted tail)."""
    Gd, Hd = _xtv_and_sqdiag_lm(lanes_major(prob), _rows(C), _rows(Dm))
    return Gd.T.to(C.dtype), Hd.T.to(Dm.dtype)


def fun_grad_curvature(prob: MultiProblem, W: torch.Tensor,
                       with_diag: bool = False, group=None):
    """(F, G, Dm), or (F, G, Dm, Hd) with the Jacobi diagonal `with_diag`,
    sharing one scores pass: equal to (fun, *grad_and_curvature) and, with
    the diagonal, hessian_diagonal(prob, Dm). F is (L,) in the accumulate
    type, the others (·, L) in W's dtype."""
    out = _fun_grad_curvature_lm(lanes_major(prob), W.T, with_diag,
                                 group=group)
    return (out[0],) + tuple(t.T for t in out[1:])


def grad_norm_at_zero(prob: MultiProblem, n_rhs: int,
                      group=None) -> torch.Tensor:
    """(L,) ||grad at W=0|| over the feature axis (the reference stop rule's
    gnorm1) in one X'v pass: Xv(0) == 0 exactly."""
    return _grad_norm_at_zero_lm(lanes_major(prob), n_rhs, group)


def hv(prob: MultiProblem, Dm: torch.Tensor, S: torch.Tensor,
       group=None) -> torch.Tensor:
    """(n, L) Hessian-vector products of every lane, in S's dtype."""
    return _hv_lm(lanes_major(prob), _rows(Dm), S.T, group).T


def hessian_diagonal(prob: MultiProblem, Dm: torch.Tensor) -> torch.Tensor:
    """(n, L) diag(H) per lane: prior_var_inv + sum_i Dm_i x_i^2, the Jacobi
    preconditioner, in Dm's dtype."""
    return _hessian_diagonal_lm(lanes_major(prob), _rows(Dm)).T.to(
        Dm.dtype)


class MultiSolver:
    """`tron_multi`'s two loops as functions of a state, so that the eager
    solve and the device loop of AdmmTrainer.run_fused run the same ops:
    `init` (the Newton init), `running`, `cg_init`, `cg_open`, `cg_trip`
    (one trip of the CG loop) and `epilogue` (the Newton step that follows
    the CG loop). None of them reads the device from the host. `prob` is
    lanes-major (`lanes_major`); every other argument is tron_multi's."""

    def __init__(self, prob: MultiProblem, L: int, precondition=False,
                 blocks: int = 1, max_iter: int = 1000,
                 max_cg_iter: int = 500, group=None):
        B = int(blocks)
        kind = {False: "none", True: "jacobi"}.get(precondition, precondition)
        if kind not in ("none", "jacobi", "head_block"):
            raise ValueError(
                f"precondition must be False/True/'jacobi'/'head_block'; "
                f"got {precondition!r}")
        # a batched head needs one block per segment: the flat-blocks solve
        # (B = 1 over a stacked head) has no per-block head Gram, as in JAX
        if kind == "head_block" and (prob.head_x is None or (
                prob.head_x.dim() == 3 and (B == 1
                                            or prob.head_x.shape[0] != B))):
            raise ValueError("head_block preconditioning needs the hybrid "
                             "dense-head layout (head_size > 0, non-flat)")
        N = prob.prior_mean.shape[-1]
        if N % B or prob.y.shape[0] % B:
            raise ValueError(f"blocks={B} does not divide the stacked "
                             f"problem's {N} columns and {prob.y.shape[0]} "
                             f"rows")
        self.prob, self.L, self.B, self.kind = prob, L, B, kind
        self.max_iter, self.max_cg_iter = max_iter, max_cg_iter
        self.group = group
        self.flat = (L, -1)
        self.stall_rtol = 1e-12 if prob.prior_mean.dtype == torch.float64 \
            else 1e-5

    # -- pieces ---------------------------------------------------------
    def fgc(self, W, with_diag):
        out = _fun_grad_curvature_lm(self.prob, W.view(self.flat), with_diag,
                                     self.B, self.group)
        return (out[0],) + tuple(_seg(t, self.B) for t in out[1:])

    def precond_of(self, Dm, Hd):
        if self.kind == "head_block":
            return build_head_precond(self.prob, Dm.view(self.flat),
                                      Hd.view(self.flat))
        return torch.clamp(Hd, min=1e-12)

    def _cg_ops(self, M):
        """(precond, mdot) of the CG under M: M None reproduces the
        reference; an (L, B, n) Jacobi diagonal or a HeadBlockPrecond
        measures the trust region in the M-norm and tests the residual in
        ||r||_{M^-1}. Every dot goes through the shards' all_reduce."""
        L, B, group, flat = self.L, self.B, self.group, self.flat
        if M is None:
            def precond(r):
                return r

            def mdot(a, b):
                return _dot_lm(a, b, group)
        elif isinstance(M, HeadBlockPrecond):
            def precond(r):
                return _head_solve(M, r.view(flat)).view(L, B, -1)

            def mdot(a, b):
                return _dot_lm(a, _head_apply(M, b.view(flat)).view(L, B, -1),
                               group)
        else:
            def precond(r):
                return r / M

            def mdot(a, b):
                return _dot_lm(a * M, b, group)
        return precond, mdot

    # -- the Newton loop --------------------------------------------------
    def init(self, W0: torch.Tensor, eps) -> NewtonState:
        """The state before the first Newton trip, from W0 (n, L)."""
        L, B, group, dev = self.L, self.B, self.group, W0.device
        dtype = W0.dtype
        eps = torch.as_tensor(eps, dtype=dtype, device=dev).expand(L, B)
        W = _seg(W0.T.contiguous(), B)
        gnorm1 = _norm_lm(_seg(_grad_at_zero_lm(self.prob, L), B), group)
        if self.kind == "none":
            F, G, Dm = self.fgc(W, False)
            M = None
            delta = _norm_lm(G, group)
        else:
            F, G, Dm, Hd0 = self.fgc(W, True)
            M = self.precond_of(Dm, Hd0)
            Minv_G = (_seg(_head_solve(M, G.view(self.flat)), B)
                      if self.kind == "head_block" else G / M)
            delta = torch.sqrt(_dot_lm(G, Minv_G, group))
        gnorm = _norm_lm(G, group)
        it = torch.ones((L, B), dtype=torch.int32, device=dev)
        active = gnorm > eps * gnorm1
        zeros_b = torch.zeros(B, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return NewtonState(W=W, F=F, G=G, Dm=Dm, M=M, delta=delta,
                           gnorm=gnorm, gnorm1=gnorm1, eps=eps, it=it,
                           active=active, block_nt=zeros_b,
                           block_cg=zeros_b.clone(), trips=zero,
                           cg_trips=zero.clone())

    def running(self, ns: NewtonState) -> torch.Tensor:
        """(1, B): a block's loop runs while one of its lanes is active and
        under the cap; a block whose loop has ended keeps its whole
        state."""
        return (ns.active & (ns.it <= self.max_iter)).any(0, keepdim=True)

    # -- the CG loop ------------------------------------------------------
    def cg_init(self, ns: NewtonState, running: torch.Tensor) -> CgState:
        L, B, group = self.L, self.B, self.group
        precond, _ = self._cg_ops(ns.M)
        G = ns.G
        z = precond(-G)
        rz = _dot_lm(-G, z, group)
        return CgState(
            s=torch.zeros_like(G), r=-G, z=z, d=z, rz=rz,
            cgtol=0.1 * torch.sqrt(rz), done=~running.expand(L, B),
            it=torch.zeros((), dtype=torch.int64, device=G.device),
            block_it=torch.zeros(B, dtype=torch.int64, device=G.device),
            running=running)

    def cg_open(self, cs: CgState) -> torch.Tensor:
        """0-d bool: the CG loop takes another trip."""
        return (cs.it < self.max_cg_iter) & (~cs.done).any()

    def cg_trip(self, ns: NewtonState, cs: CgState) -> CgState:
        """One lock-step CG trip: a data pass (Hv) serving every lane, the
        lanes already done kept as they are."""
        group, B, flat = self.group, self.B, self.flat
        precond, mdot = self._cg_ops(ns.M)
        s, r, z, d, rz, done = cs.s, cs.r, cs.z, cs.d, cs.rz, cs.done
        delta = ns.delta
        block_it = cs.block_it + (~done).any(0)
        small = torch.sqrt(torch.clamp(_dot_lm(r, z, group),
                                       min=0.0)) <= cs.cgtol

        Hd = _seg(_hv_lm(self.prob, ns.Dm.view(flat), d.view(flat), group), B)
        dHd = _dot_lm(d, Hd, group)
        alpha = _safe_div(rz, dHd, dHd > 0)
        s_try = s + alpha[..., None] * d
        boundary = torch.sqrt(mdot(s_try, s_try)) > delta

        std = mdot(s, d)
        sts = mdot(s, s)
        dtd = mdot(d, d)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
        denom_pos = std + rad
        alpha_b = torch.where(std >= 0,
                              _safe_div(dsq - sts, denom_pos, denom_pos != 0),
                              _safe_div(rad - std, dtd, dtd != 0))

        s_bnd = s + alpha_b[..., None] * d
        r_bnd = r - alpha_b[..., None] * Hd
        r_int = r - alpha[..., None] * Hd
        z_int = precond(r_int)
        rz_new = _dot_lm(r_int, z_int, group)
        beta = _safe_div(rz_new, rz, rz > 0)
        d_int = z_int + beta[..., None] * d

        step = ~small & ~done
        take_bnd = step & boundary
        take_int = step & ~boundary
        bnd2, int2 = take_bnd[..., None], take_int[..., None]
        vt = s.dtype        # the kept vectors round once (float32 scalars)
        return cs._replace(
            s=torch.where(bnd2, s_bnd, torch.where(int2, s_try, s)).to(vt),
            r=torch.where(bnd2, r_bnd, torch.where(int2, r_int, r)).to(vt),
            z=torch.where(int2, z_int, z).to(vt),
            d=torch.where(int2, d_int, d).to(vt),
            rz=torch.where(take_int, rz_new, rz),
            done=done | small | take_bnd, it=cs.it + 1, block_it=block_it)

    # -- the Newton step after the CG loop --------------------------------
    def epilogue(self, ns: NewtonState, cs: CgState) -> NewtonState:
        """The trial point, its fused f/g/D (+ diag) data pass, the trust
        region update and the accept select, for the blocks of
        cs.running; the others keep their whole state."""
        group, B, flat, kind = self.group, self.B, self.flat, self.kind
        _, mdot = self._cg_ops(ns.M)
        S, Rres, running = cs.s, cs.r, cs.running
        snorm = torch.sqrt(torch.clamp(mdot(S, S), min=0.0))
        W, F, G, Dm, M = ns.W, ns.F, ns.G, ns.Dm, ns.M
        delta, it, active = ns.delta, ns.it, ns.active
        W_new = W + S
        gs = _dot_lm(G, S, group)
        prered = -0.5 * (gs - _dot_lm(S, Rres, group))
        # one fused data pass yields f/g/D (+ diag) at the trial point; the
        # accept select below discards them on rejection
        if kind == "none":
            F_new, G_new, Dm_new = self.fgc(W_new, False)
        else:
            F_new, G_new, Dm_new, Hd_new = self.fgc(W_new, True)
            M_new = self.precond_of(Dm_new, Hd_new)
        actred = F - F_new

        delta = torch.where(running & (it == 1),
                            torch.minimum(delta, snorm), delta)
        denom = F_new - F - gs
        alpha = torch.where(
            denom <= 0, torch.full_like(denom, SIGMA3),
            torch.clamp(-0.5 * (gs / torch.where(denom <= 0,
                                                 torch.ones_like(denom),
                                                 denom)), min=SIGMA1))
        asn = alpha * snorm
        delta_new = torch.where(
            actred < ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm,
                          SIGMA2 * delta),
            torch.where(
                actred < ETA1 * prered,
                torch.maximum(SIGMA1 * delta,
                              torch.minimum(asn, SIGMA2 * delta)),
                torch.where(
                    actred < ETA2 * prered,
                    torch.maximum(SIGMA1 * delta,
                                  torch.minimum(asn, SIGMA3 * delta)),
                    torch.maximum(delta,
                                  torch.minimum(asn, SIGMA3 * delta)))))
        live = active & running
        delta = torch.where(live, delta_new.to(delta.dtype), delta)

        accept = live & (actred > ETA0 * prered)
        acc3 = accept[..., None]
        W = torch.where(acc3, W_new, W)
        F = torch.where(accept, F_new, F)
        G = torch.where(acc3, G_new, G)
        Dm = torch.where(acc3, Dm_new, Dm)
        if kind == "head_block":
            accc = accept.view(*M.chol.shape[:-2], 1, 1)
            M = M._replace(
                chol=torch.where(accc, M_new.chol, M.chol),
                diag=torch.where(acc3, _seg(M_new.diag, B),
                                 _seg(M.diag, B)).view(flat))
        elif kind == "jacobi":
            M = torch.where(acc3, M_new, M)
        gnorm = torch.where(accept, _norm_lm(G_new, group), ns.gnorm)
        it = it + accept.to(torch.int32)

        eps, gnorm1 = ns.eps, ns.gnorm1
        done = accept & (gnorm <= eps * gnorm1)
        done = done | (F < -1.0e32)
        done = done | ((torch.abs(actred) <= 0) & (prered <= 0))
        done = done | ((torch.abs(actred) <= self.stall_rtol * torch.abs(F))
                       & (torch.abs(prered)
                          <= self.stall_rtol * torch.abs(F)))
        return ns._replace(
            W=W, F=F, G=G, Dm=Dm, M=M, delta=delta, gnorm=gnorm, it=it,
            active=active & ~(done & live),
            block_nt=ns.block_nt + running[0],
            block_cg=ns.block_cg + cs.block_it, trips=ns.trips + 1,
            cg_trips=ns.cg_trips + cs.it)

    # -- the result ---------------------------------------------------------
    def block_trips(self, ns: NewtonState) -> torch.Tensor:
        """(B, 2) int64 on the device: each block's Newton and CG trips."""
        return torch.stack([ns.block_nt, ns.block_cg], 1)

    def result(self, ns: NewtonState) -> MultiTronResult:
        """The solve's result, with the trip counters read to the host."""
        def out(t):
            return t[:, 0] if self.B == 1 else t
        return MultiTronResult(
            w=ns.W.reshape(self.flat).T, f=out(ns.F), gnorm=out(ns.gnorm),
            iterations=out(ns.it - 1),
            converged=out(ns.gnorm <= ns.eps * ns.gnorm1),
            newton_trips=int(ns.trips), cg_trips=int(ns.cg_trips),
            block_trips=self.block_trips(ns).cpu().numpy())


def tron_multi(prob: MultiProblem, W0: torch.Tensor, eps,
               max_iter: int = 1000, max_cg_iter: int = 500,
               precondition=False, blocks: int = 1,
               group=None) -> MultiTronResult:
    """Warm-started TRON over L simultaneous lambda-problems (Tron.java:30-124
    per lane; stall thresholds as in mlease_tpu/ops/tron.py).

    precondition=True or "jacobi" runs the Jacobi-preconditioned CG with an
    M-norm trust region; "head_block" also solves the dense-head curvature
    block exactly (HeadBlockPrecond; it needs the hybrid layout, one block
    or a per-block head with blocks=B); False or "none" the reference CG.
    The outer stop rule (euclidean ||g|| <= eps*||g0||) is the same for all.

    blocks=B > 1 solves the stacked problem's B blocks (rows and columns in
    B equal segments, as stack_blocks lays them out) as B independent
    problems, each (lambda, block) lane with its own trust region, CG and
    stop rule: the JAX package's vmap of tron_multi over blocks. eps is
    then a scalar or (B,), one tolerance per block.

    group (a torch.distributed process group) solves a problem whose
    columns are sharded over the group's ranks (shard-local ids; W0 and the
    priors this rank's (n_local, L) slices): the JAX package's axis_name.
    Every rank of the group must make the same call.

    The loops run on the host: one read of "any lane open" per CG trip and
    per Newton trip (MultiSolver holds the trips themselves)."""
    solver = MultiSolver(lanes_major(prob), W0.shape[1], precondition,
                         blocks, max_iter, max_cg_iter, group)
    ns = solver.init(W0, eps)
    while True:
        running = solver.running(ns)
        if not bool(running.any()):
            break
        cs = solver.cg_init(ns, running)
        while bool(solver.cg_open(cs)):
            cs = solver.cg_trip(ns, cs)
        ns = solver.epilogue(ns, cs)
    return solver.result(ns)
