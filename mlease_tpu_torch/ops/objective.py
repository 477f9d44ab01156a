"""Weighted logistic regression with a Gaussian prior: the x-update objective.

Port of mlease_tpu/ops/objective.py. The math matches the reference
objective (LogisticRegressionL2.java:31-46):

    score_i(w) = w'x[i] + offset[i]
    loss(w)  = 1/2 * sum_k (w[k]-priorMean[k])^2 / priorVar[k]
             + sum_i weight[i] * log(1 + exp(-y[i] * score_i(w)))
    loss'(w) = (w-priorMean)/priorVar + sum_i weight[i]*(p_i - 1)*y_i*x[i]
    loss''(w)= diag(1/priorVar) + X' D X,  D_ii = weight[i]*p_i*(1-p_i)
    with p_i = sigmoid(y_i * score_i(w))

on the padded ELL block layout of core/dataset.py (padding slots carry
value 0 and contribute nothing to either pass).

Where the JAX package vmaps these functions over a (lambda x block) or
(grid x item) axis, the port batches them explicitly: every array of an
`LRProblem` and every vector argument carries a leading problem axis P
(`torch.func.vmap` cannot carry the data-dependent solver loops that sit
above these functions). The data may also be shared by several lanes:
with data blocks (B, ...) and lane vectors (P, n), P = L*B, lane l*B + b
solves on block b, and the ids are stride-0 views, never L copies (the
JAX package's vmap over lambdas with the data's in_axes None). Index
arrays are int64, as torch's gather and scatter want them. The ELL
scatter-add becomes one batched `scatter_add_`; the dense Hessian of
`dense_hessian` is the hand-written kernel of ops/gram.py on the card.

On the card the sums over sorted streams (the column-sorted copy of the
ELL nonzeros, the row-sorted and column-sorted tails) are K1
(`_sorted_sum`), whose sums run in one fixed order: scatter_add_'s atomics
sum in another order on every run, and a device loop and the host-driven
solve it replaces could then not give the same bits, nor two runs of one
solve. The ADMM and naive lanes problems, the item buckets and `fit`'s
problem (`make_problem`) carry a column-sorted copy on the card for this,
and every sorted stream's ids as K1 reads them (`K1Streams`), made once
with the problem (train/admm.py::blocked_problem): X'v (and through it
the gradient and Hv) and the Hessian diagonal sum over it with K1. The
ELL scatter of a problem without the copy and the scatter over a
row-sorted tail without its column-sorted one run on the CPU only
(`segment_sum.host_scatter_only`); no problem the port builds on the card
lacks either copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops.gram import gram_batched
from mlease_tpu_torch.ops.segment_sum import (accumulate_dtype,
                                              host_scatter_only,
                                              segment_sum_gather)
from mlease_tpu_torch.ops.tron_multi import substack_ranges


class K1Streams(NamedTuple):
    """An LRProblem's sorted streams as K1 reads them on the card: each a
    (seg, idx) pair of (B, T) int32 ids, offset by a block's place in its
    range of `ranges` (seg by the sums' width, idx by the gathered
    vector's), so that each range is one K1 call over its blocks stacked
    and its ids stay inside int32."""

    ranges: tuple                # ((b0, b1), ...) consecutive, covering B
    csc: tuple | None = None     # (csc_cols + b*n, csc_rows + b*R)
    tail: tuple | None = None    # (tail_rows + b*R, tail_cols + b*n)
    tail_c: tuple | None = None  # (tail_c_cols + b*n, tail_c_rows + b*R)


class LRProblem(NamedTuple):
    """P x-update problems over B padded data blocks: every data array
    carries the leading block axis B, and prior_mean / prior_var_inv (and
    every vector the functions take) the problem axis P, a multiple of B
    (P = B: each problem its own block; P = L*B: L lanes per block).

    The optional csc_* arrays are the column-sorted dual layout of the same
    nonzeros; head_x/head_ids the dense hot columns of the hybrid layout;
    tail_* its flat-COO cold tail, and tail_c_* the same tail sorted by
    column (mlease_tpu/ops/objective.py describes why the JAX package keeps
    them)."""

    indices: torch.Tensor        # (B, R, K) int64 vocab columns
    values: torch.Tensor         # (B, R, K), 0.0 on padding
    y: torch.Tensor              # (B, R), +1/-1 (+1 on padding rows)
    weight: torch.Tensor         # (B, R), Cp/Cn-folded, 0 on padding rows
    offset: torch.Tensor         # (B, R)
    prior_mean: torch.Tensor     # (P, n)
    prior_var_inv: torch.Tensor  # (P, n)
    csc_cols: torch.Tensor | None = None   # (B, R*K) int64 sorted ascending
    csc_rows: torch.Tensor | None = None   # (B, R*K) int64
    csc_vals: torch.Tensor | None = None   # (B, R*K)
    head_x: torch.Tensor | None = None     # (B, R, H) dense hot columns
    head_ids: torch.Tensor | None = None   # (B, H) int64 vocab ids
    tail_rows: torch.Tensor | None = None  # (B, T) int64 sorted ascending
    tail_cols: torch.Tensor | None = None  # (B, T) int64
    tail_vals: torch.Tensor | None = None  # (B, T)
    tail_c_rows: torch.Tensor | None = None  # (B, T) int64
    tail_c_cols: torch.Tensor | None = None  # (B, T) int64 sorted ascending
    tail_c_vals: torch.Tensor | None = None  # (B, T)
    k1: K1Streams | None = None  # the sorted streams' ids on the card

    @property
    def dim(self) -> int:
        return self.prior_mean.shape[-1]


def make_problem(block, prior_mean, prior_var_inv, *,
                 positive_weight: float = 1.0, dtype=torch.float32,
                 device="cuda") -> LRProblem:
    """Build an LRProblem from a packed Block (P = 1) or from arrays that
    already carry the problem axis (BlockedData: P = B), on the card unless
    the caller asks for device="cpu" (the solvers run where their problem
    lies, so this decides whether they launch the kernels).

    positive_weight is the reference's Cp (LogisticRegressionL2.java:93-99);
    Cn = 1. On the card the problem carries the column-sorted copy of its
    ELL and K1's ids (`with_sorted_streams`)."""
    device = resolve_device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    indices = torch.as_tensor(np.asarray(block.indices), device=device).long()
    batched = indices.dim() == 3
    lift = (lambda t: t) if batched else (lambda t: t[None])
    y = f(block.y)
    weight = f(block.weight)
    if positive_weight != 1.0:
        weight = torch.where(y == 1, positive_weight * weight, weight)
    prob = LRProblem(
        indices=lift(indices), values=lift(f(block.values)), y=lift(y),
        weight=lift(weight), offset=lift(f(block.offset)),
        prior_mean=lift(f(prior_mean)), prior_var_inv=lift(f(prior_var_inv)))
    return with_sorted_streams(prob, prob.prior_mean.shape[-1])


def _lanes(prob: LRProblem, v: torch.Tensor) -> torch.Tensor:
    """A (P, m) lane vector as (L, B, m), B the data's problem axis: lane
    l*B + b solves on data block b (P = L*B; L = 1 when every problem has
    its own data)."""
    return v.view(-1, prob.y.shape[0], v.shape[-1])


def _ids(ids: torch.Tensor, L: int) -> torch.Tensor:
    """A (B, m) id array as a stride-0 (L, B, m) view: the data is shared
    by the L lanes, never copied."""
    return ids.reshape(ids.shape[0], -1)[None].expand(L, -1, -1)


def _zeros3(prob: LRProblem, L: int, width: int) -> torch.Tensor:
    """A zero (L, B, width) scatter-add target in the accumulate type
    (bfloat16 sums in float32 and rounds once, as K1 sums: on the card a
    bfloat16 scatter-add rounds after every entry)."""
    return torch.zeros((L, prob.y.shape[0], width),
                       dtype=accumulate_dtype(prob.values.dtype),
                       device=prob.values.device)


def column_sorted(indices: torch.Tensor, values: torch.Tensor):
    """The column-sorted copy of every block's ELL nonzeros (the dual
    layout, core/dataset.py::csc_arrays, made on the device): (cols, rows,
    vals), each (B, R*K), stably sorted by column id per block; int64
    ids."""
    B, R, K = indices.shape
    cols = indices.reshape(B, -1).long()
    order = torch.sort(cols, dim=1, stable=True).indices
    return (cols.gather(1, order), order // K,
            values.reshape(B, -1).gather(1, order))


def with_sorted_streams(prob: LRProblem, n: int, csc=None,
                        k1=None) -> LRProblem:
    """prob with the column-sorted copy of its ELL (`csc`, the (cols, rows,
    vals) of column_sorted, each (B, R*K); on the card made here when not
    given) and, on the card, its sorted streams' K1 ids (`k1`, made here
    when not given, over the sub-stacks that keep them inside int32); n
    columns. Both once per problem: on the card X'v and the Hessian
    diagonal then sum with K1, in one order every run."""
    B, R, K = prob.indices.shape
    on_card = prob.indices.is_cuda
    if csc is None and on_card and K > 0:
        csc = column_sorted(prob.indices, prob.values)
    if csc is not None:
        cols, rows, vals = csc
        prob = prob._replace(csc_cols=cols.long(), csc_rows=rows.long(),
                             csc_vals=vals)
    if on_card:
        prob = prob._replace(k1=k1 if k1 is not None else k1_streams(
            prob, n, substack_ranges(B, n, R)))
    return prob


def k1_streams(prob: LRProblem, n: int, ranges) -> K1Streams:
    """prob's sorted streams (per-block ids, n columns) as K1Streams over
    the block ranges `ranges`, each of which the caller keeps inside int32
    (ops/tron_multi.py::substack_ranges)."""
    B, R = prob.y.shape
    # each block's place in its range, made on the device (no host copy)
    local = torch.arange(B, device=prob.y.device)
    for b0, b1 in ranges:
        local[b0:b1] -= b0
    local = local[:, None]

    def pair(seg, seg_w, idx, idx_w):
        if seg is None:
            return None
        return ((seg + local * seg_w).to(torch.int32),
                (idx + local * idx_w).to(torch.int32))
    return K1Streams(tuple(ranges),
                     csc=pair(prob.csc_cols, n, prob.csc_rows, R),
                     tail=pair(prob.tail_rows, R, prob.tail_cols, n),
                     tail_c=pair(prob.tail_c_cols, n, prob.tail_c_rows, R))


# each sorted stream's segment ids, gather ids and values
_STREAMS = {"csc": ("csc_cols", "csc_rows", "csc_vals"),
            "tail": ("tail_rows", "tail_cols", "tail_vals"),
            "tail_c": ("tail_c_cols", "tail_c_rows", "tail_c_vals")}


def _sorted_sum(prob: LRProblem, stream: str, out3: torch.Tensor,
                V3: torch.Tensor, square: bool = False) -> torch.Tensor:
    """out3[l, b, seg[b, t]] += vals[b, t] * V3[l, b, idx[b, t]], in place,
    over one of prob's sorted streams (_STREAMS), for out3 (L, B, W) and
    V3 (L, B, m) in the accumulate type; `square`: vals[b, t]^2 in its
    place, formed in V3's type (K1's square_from). The CPU runs the batched
    scatter_add_; the card runs K1 over prob.k1's ids, one call per block
    range."""
    seg, idx, vals = (getattr(prob, f) for f in _STREAMS[stream])
    if not out3.is_cuda:
        if square:
            vals = vals.to(V3.dtype)
            vals = vals * vals
        return out3.scatter_add_(2, _ids(seg, out3.shape[0]),
                                 vals * V3.gather(2, _ids(idx, V3.shape[0])))
    if prob.k1 is None:
        raise ValueError(f"the sorted stream {stream!r} on the card needs "
                         f"its K1 ids (LRProblem.k1)")
    return _k1_sorted_sum(out3, getattr(prob.k1, stream), vals, V3,
                          prob.k1.ranges, square)


def _k1_sorted_sum(out3, ids, vals, V3, ranges, square=False):
    """_sorted_sum through K1's wrapper (its plain version on a CPU
    tensor), ids a K1Streams pair: a bfloat16 stream is widened to V3's
    float32 (the same products and float32 sums); `square` has K1 square
    the values in every lane (square_from 0)."""
    seg, idx = ids
    L, B, W = out3.shape
    if seg.shape[1] == 0:
        return out3
    m = V3.shape[2]
    vals = vals.to(V3.dtype)
    for b0, b1 in ranges:
        nb = b1 - b0
        o = out3[:, b0:b1]
        flat = (o if o.is_contiguous() else o.contiguous()).view(L, nb * W)
        segment_sum_gather(vals[b0:b1].reshape(-1),
                           V3[:, b0:b1].reshape(L, nb * m),
                           idx[b0:b1].reshape(-1), seg[b0:b1].reshape(-1),
                           nb * W, out=flat, square_from=0 if square else None)
        if flat.data_ptr() != o.data_ptr():
            o.copy_(flat.view(L, nb, W))
    return out3


# ---------------------------------------------------------------------------
# Sparse matvecs (reference Xv/XTv, LogisticRegressionL2.java:115-150)
# ---------------------------------------------------------------------------

def _xv3(prob: LRProblem, v3: torch.Tensor) -> torch.Tensor:
    """X @ v on (L, B, n) lanes -> (L, B, R) in the accumulate type: for a
    bfloat16 v the scores stay float32, products of the data as stored and
    the widened v, every sum in float32; the dense head's product is a
    bfloat16 bmm, accumulated in float32 and rounded once
    (ops/tron_multi.py's docstring states the rule for both solvers)."""
    L = v3.shape[0]
    B, R = prob.y.shape
    K = prob.indices.shape[-1]
    va = v3.to(accumulate_dtype(v3.dtype))
    if K > 0:
        gathered = va.gather(2, _ids(prob.indices, L))
        out = (prob.values * gathered.view(L, B, R, K)).sum(-1)
    else:
        out = torch.zeros((L, B, R), dtype=va.dtype, device=va.device)
    if prob.head_x is not None:
        hv_ = v3.gather(2, _ids(prob.head_ids, L))             # (L, B, H)
        out = out + torch.bmm(prob.head_x,
                              hv_.permute(1, 2, 0)).permute(2, 0, 1)
    if prob.tail_cols is not None:
        out = out + _sorted_sum(prob, "tail", _zeros3(prob, L, R), va)
    return out


def xv(prob: LRProblem, v: torch.Tensor) -> torch.Tensor:
    """X @ v: (P, n) -> (P, R) scores, in the accumulate type. ELL: gather
    + row reduction; hybrid: the dense head product plus a flat-COO pass
    over the tail."""
    return _xv3(prob, _lanes(prob, v)).reshape(v.shape[0], -1)


def xtv(prob: LRProblem, d: torch.Tensor) -> torch.Tensor:
    """X' @ d: (P, R) -> (P, n) accumulation (one batched scatter-add; with
    the CSC dual layout, the column-sorted copy of the same nonzeros). d is
    in the accumulate type (float32 for bfloat16 data: the products of the
    data as stored and d, every sum in float32)."""
    d3 = _lanes(prob, d)
    L = d3.shape[0]
    K = prob.indices.shape[-1]
    out = _zeros3(prob, L, prob.dim)
    if prob.csc_cols is not None:
        _sorted_sum(prob, "csc", out, d3)
    elif K > 0:
        host_scatter_only(d3, "X'v over the ELL")
        out.scatter_add_(2, _ids(prob.indices, L),
                         (prob.values * d3[..., None]).flatten(2))
    if prob.head_x is not None:     # the GEMM reads d in the head's type
        head = torch.bmm(prob.head_x.transpose(1, 2),
                         d3.to(prob.head_x.dtype).permute(1, 2, 0))
        out.scatter_add_(2, _ids(prob.head_ids, L),
                         head.permute(2, 0, 1).to(out.dtype))
    if prob.tail_c_cols is not None:
        _sorted_sum(prob, "tail_c", out, d3)
    elif prob.tail_cols is not None:
        host_scatter_only(d3, "X'v over a row-sorted tail")
        out.scatter_add_(2, _ids(prob.tail_cols, L), prob.tail_vals
                         * d3.gather(2, _ids(prob.tail_rows, L)))
    return out.reshape(d.shape[0], -1)


def _scores3(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    return _xv3(prob, _lanes(prob, w)) + prob.offset


def scores(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    return _scores3(prob, w).reshape(w.shape[0], -1)


# ---------------------------------------------------------------------------
# Objective value / gradient / Hessian products
# ---------------------------------------------------------------------------

def _curvature(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """D_ii = weight_i * p_i * (1 - p_i) at w, rounded once to w's type."""
    p = torch.sigmoid(prob.y * _scores3(prob, w))
    return (prob.weight * p * (1.0 - p)).to(w.dtype).reshape(w.shape[0], -1)


def fun(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """loss(w), (P,), in the accumulate type. log(1 + exp(-yz)) as
    logaddexp(0, -yz), the stable two-branch form of
    LogisticRegressionL2.java:170-177. For a bfloat16 w the margins, the
    row losses, the prior term and their sum stay float32, as
    ops/tron_multi.py keeps its F: a bfloat16 objective of about 100
    moves in steps of 0.5 (the JAX package's does, ROADMAP C9), and the
    trust region and the line search, which weigh a step by the difference
    of two objectives, would refuse every step that gains less."""
    yz = prob.y * _scores3(prob, w)
    data_loss = (prob.weight * torch.logaddexp(yz.new_zeros(()), -yz)).sum(-1)
    dw = w.to(yz.dtype) - prob.prior_mean
    return data_loss.reshape(-1) + 0.5 * (dw * dw * prob.prior_var_inv).sum(-1)


def grad_and_curvature(prob: LRProblem, w: torch.Tensor):
    """(gradient (P, n), D (P, R)); D is the IRLS curvature reused by
    Hessian-vector products (LogisticRegressionL2.java:199-225). For a
    bfloat16 w both are formed in float32 and round once to w's type."""
    p = torch.sigmoid(prob.y * _scores3(prob, w))
    coeff = (prob.weight * (p - 1.0) * prob.y).reshape(w.shape[0], -1)
    g = xtv(prob, coeff).to(w.dtype) \
        + (w - prob.prior_mean) * prob.prior_var_inv
    return g, (prob.weight * p * (1.0 - p)).to(w.dtype).reshape(
        w.shape[0], -1)


def grad(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    return grad_and_curvature(prob, w)[0]


def hv(prob: LRProblem, D: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(diag(1/priorVar) + X' D X) @ s: two sparse passes
    (LogisticRegressionL2.java:231-248); for a bfloat16 s, D * Xs and the
    product in float32, rounded once to s's type."""
    return (xtv(prob, D * xv(prob, s)).to(s.dtype)
            + s * prob.prior_var_inv)


def hessian_diagonal(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """diag(H) = 1/priorVar + sum_i D_ii x_ik^2
    (LogisticRegressionL2.java:304-327); the Laplace diagonal posterior
    variance is 1/this (LibLinear.java:330-333)."""
    q3 = _lanes(prob, _curvature(prob, w))
    L = q3.shape[0]
    K = prob.indices.shape[-1]
    acc = accumulate_dtype(prob.prior_var_inv.dtype)
    out = _lanes(prob, prob.prior_var_inv.to(acc, copy=True))
    if prob.csc_cols is not None:   # the column-sorted copy, K1 on the card
        _sorted_sum(prob, "csc", out, q3.to(acc), square=True)
    elif K > 0:
        host_scatter_only(q3, "The Hessian diagonal over the ELL")
        out.scatter_add_(2, _ids(prob.indices, L),
                         (prob.values * prob.values
                          * q3[..., None]).flatten(2).to(acc))
    if prob.head_x is not None:
        sq = prob.head_x * prob.head_x
        head = torch.bmm(sq.transpose(1, 2), q3.permute(1, 2, 0))
        out.scatter_add_(2, _ids(prob.head_ids, L),
                         head.permute(2, 0, 1).to(acc))
    if prob.tail_c_cols is not None:
        _sorted_sum(prob, "tail_c", out, q3.to(acc), square=True)
    elif prob.tail_cols is not None:
        host_scatter_only(q3, "The Hessian diagonal over a row-sorted tail")
        out.scatter_add_(2, _ids(prob.tail_cols, L), (
            prob.tail_vals * prob.tail_vals
            * q3.gather(2, _ids(prob.tail_rows, L))).to(acc))
    return out.to(w.dtype).reshape(w.shape[0], -1)


def densify(prob: LRProblem) -> torch.Tensor:
    """Padded sparse rows -> dense (B, R, n) design matrices, one per data
    block (P = B unless lanes share the data), for the per-item
    dense-Newton path where n is small."""
    P, R, K = prob.indices.shape
    n = prob.dim
    X = torch.zeros((P, R * n), dtype=prob.values.dtype,
                    device=prob.values.device)
    row_base = torch.arange(R, device=X.device)[None, :, None] * n
    if K > 0:
        X.scatter_add_(1, (row_base + prob.indices).reshape(P, R * K),
                       prob.values.reshape(P, R * K))
    if prob.head_x is not None:
        H = prob.head_ids.shape[-1]
        ids = row_base + prob.head_ids[:, None, :]
        X.scatter_add_(1, ids.reshape(P, R * H),
                       prob.head_x.reshape(P, R * H))
    if prob.tail_cols is not None:
        X.scatter_add_(1, prob.tail_rows * n + prob.tail_cols, prob.tail_vals)
    return X.reshape(P, R, n)


def dense_hessian(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """Full H = diag(1/priorVar) + X' D X, (P, n, n), through the weighted
    Gram kernel (reference: LogisticRegressionL2.hessian,
    LogisticRegressionL2.java:258-297). Only sensible for small n (per-item
    models); inverse(H) is the Laplace posterior covariance
    (LibLinear.java:317-327). Lanes that share a block's data share its
    dense rows, copied to each lane for the one batched Gram."""
    X = densify(prob)
    lanes = w.shape[0] // X.shape[0]
    return gram_batched(X.repeat(lanes, 1, 1) if lanes > 1 else X,
                        _curvature(prob, w), prob.prior_var_inv)


# ---------------------------------------------------------------------------
# Class-balance tolerance scaling (host-side, static per dataset)
# ---------------------------------------------------------------------------

def class_balance_eps_scale(y: np.ndarray, nrows) -> np.ndarray:
    """eps_effective = eps * min(pos, neg) / l, per problem (reference:
    LibLinear.java:272-276,309-313). `y` is (..., R) padded labels and `nrows`
    the per-problem real row count; padding rows (index >= nrows) are excluded.
    Returns the min(pos,neg)/l factor (1.0 when a block is empty).
    """
    y = np.asarray(y)
    nrows = np.asarray(nrows)
    R = y.shape[-1]
    mask = np.arange(R) < nrows[..., None]
    pos = np.sum((y == 1) & mask, axis=-1)
    l = np.maximum(np.sum(mask, axis=-1), 1)
    neg = np.sum(mask, axis=-1) - pos
    scale = np.minimum(pos, neg) / l
    return np.where(np.sum(mask, axis=-1) > 0, scale, 1.0)
