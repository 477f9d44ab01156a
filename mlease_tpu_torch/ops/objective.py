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
above these functions). Index arrays are int64, as torch's gather and
scatter want them. The ELL scatter-add becomes one batched `scatter_add_`;
the dense Hessian of `dense_hessian` is the hand-written kernel of
ops/gram.py on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops.gram import gram_batched


class LRProblem(NamedTuple):
    """P x-update problems over P padded data blocks; every array carries
    the leading problem axis.

    The optional csc_* arrays are the column-sorted dual layout of the same
    nonzeros; head_x/head_ids the dense hot columns of the hybrid layout;
    tail_* its flat-COO cold tail, and tail_c_* the same tail sorted by
    column (mlease_tpu/ops/objective.py describes why the JAX package keeps
    them)."""

    indices: torch.Tensor        # (P, R, K) int64 vocab columns
    values: torch.Tensor         # (P, R, K), 0.0 on padding
    y: torch.Tensor              # (P, R), +1/-1 (+1 on padding rows)
    weight: torch.Tensor         # (P, R), Cp/Cn-folded, 0 on padding rows
    offset: torch.Tensor         # (P, R)
    prior_mean: torch.Tensor     # (P, n)
    prior_var_inv: torch.Tensor  # (P, n)
    csc_cols: torch.Tensor | None = None   # (P, R*K) int64 sorted ascending
    csc_rows: torch.Tensor | None = None   # (P, R*K) int64
    csc_vals: torch.Tensor | None = None   # (P, R*K)
    head_x: torch.Tensor | None = None     # (P, R, H) dense hot columns
    head_ids: torch.Tensor | None = None   # (P, H) int64 vocab ids
    tail_rows: torch.Tensor | None = None  # (P, T) int64 sorted ascending
    tail_cols: torch.Tensor | None = None  # (P, T) int64
    tail_vals: torch.Tensor | None = None  # (P, T)
    tail_c_rows: torch.Tensor | None = None  # (P, T) int64
    tail_c_cols: torch.Tensor | None = None  # (P, T) int64 sorted ascending
    tail_c_vals: torch.Tensor | None = None  # (P, T)

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
    Cn = 1."""
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
    return LRProblem(
        indices=lift(indices), values=lift(f(block.values)), y=lift(y),
        weight=lift(weight), offset=lift(f(block.offset)),
        prior_mean=lift(f(prior_mean)), prior_var_inv=lift(f(prior_var_inv)))


def _zeros(prob: LRProblem, width: int) -> torch.Tensor:
    return torch.zeros((prob.y.shape[0], width), dtype=prob.values.dtype,
                       device=prob.values.device)


# ---------------------------------------------------------------------------
# Sparse matvecs (reference Xv/XTv, LogisticRegressionL2.java:115-150)
# ---------------------------------------------------------------------------

def xv(prob: LRProblem, v: torch.Tensor) -> torch.Tensor:
    """X @ v: (P, n) -> (P, R) scores. ELL: gather + row reduction; hybrid:
    the dense head product plus a flat-COO pass over the tail."""
    P, R = prob.y.shape
    K = prob.indices.shape[-1]
    if K > 0:
        gathered = torch.gather(v, 1, prob.indices.reshape(P, R * K))
        out = (prob.values * gathered.reshape(P, R, K)).sum(-1)
    else:
        out = _zeros(prob, R)
    if prob.head_x is not None:
        hv_ = torch.gather(v, 1, prob.head_ids)
        out = out + torch.bmm(prob.head_x, hv_[:, :, None])[:, :, 0]
    if prob.tail_cols is not None:
        contrib = prob.tail_vals * torch.gather(v, 1, prob.tail_cols)
        out = out + _zeros(prob, R).scatter_add_(1, prob.tail_rows, contrib)
    return out


def xtv(prob: LRProblem, d: torch.Tensor) -> torch.Tensor:
    """X' @ d: (P, R) -> (P, n) accumulation (one batched scatter-add; with
    the CSC dual layout, the column-sorted copy of the same nonzeros)."""
    P, R = prob.y.shape
    K = prob.indices.shape[-1]
    out = _zeros(prob, prob.dim)
    if prob.csc_cols is not None:
        out.scatter_add_(1, prob.csc_cols,
                         prob.csc_vals * torch.gather(d, 1, prob.csc_rows))
    elif K > 0:
        out.scatter_add_(1, prob.indices.reshape(P, R * K),
                         (prob.values * d[:, :, None]).reshape(P, R * K))
    if prob.head_x is not None:
        head = torch.bmm(prob.head_x.transpose(1, 2), d[:, :, None])[:, :, 0]
        out.scatter_add_(1, prob.head_ids, head)
    if prob.tail_c_cols is not None:
        out.scatter_add_(1, prob.tail_c_cols, prob.tail_c_vals
                         * torch.gather(d, 1, prob.tail_c_rows))
    elif prob.tail_cols is not None:
        out.scatter_add_(1, prob.tail_cols,
                         prob.tail_vals * torch.gather(d, 1, prob.tail_rows))
    return out


def scores(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    return xv(prob, w) + prob.offset


# ---------------------------------------------------------------------------
# Objective value / gradient / Hessian products
# ---------------------------------------------------------------------------

def _curvature(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """D_ii = weight_i * p_i * (1 - p_i) at w."""
    p = torch.sigmoid(prob.y * scores(prob, w))
    return prob.weight * p * (1.0 - p)


def fun(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """loss(w), (P,). log(1 + exp(-yz)) as logaddexp(0, -yz), the stable
    two-branch form of LogisticRegressionL2.java:170-177."""
    yz = prob.y * scores(prob, w)
    data_loss = (prob.weight * torch.logaddexp(yz.new_zeros(()), -yz)).sum(-1)
    dw = w - prob.prior_mean
    return data_loss + 0.5 * (dw * dw * prob.prior_var_inv).sum(-1)


def grad_and_curvature(prob: LRProblem, w: torch.Tensor):
    """(gradient (P, n), D (P, R)); D is the IRLS curvature reused by
    Hessian-vector products (LogisticRegressionL2.java:199-225)."""
    p = torch.sigmoid(prob.y * scores(prob, w))
    coeff = prob.weight * (p - 1.0) * prob.y
    g = xtv(prob, coeff) + (w - prob.prior_mean) * prob.prior_var_inv
    return g, prob.weight * p * (1.0 - p)


def grad(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    return grad_and_curvature(prob, w)[0]


def hv(prob: LRProblem, D: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(diag(1/priorVar) + X' D X) @ s: two sparse passes
    (LogisticRegressionL2.java:231-248)."""
    return xtv(prob, D * xv(prob, s)) + s * prob.prior_var_inv


def hessian_diagonal(prob: LRProblem, w: torch.Tensor) -> torch.Tensor:
    """diag(H) = 1/priorVar + sum_i D_ii x_ik^2
    (LogisticRegressionL2.java:304-327); the Laplace diagonal posterior
    variance is 1/this (LibLinear.java:330-333)."""
    P, R = prob.y.shape
    K = prob.indices.shape[-1]
    q = _curvature(prob, w)
    out = prob.prior_var_inv.clone()
    if K > 0:
        out.scatter_add_(1, prob.indices.reshape(P, R * K),
                         (prob.values * prob.values
                          * q[:, :, None]).reshape(P, R * K))
    if prob.head_x is not None:
        sq = prob.head_x * prob.head_x
        out.scatter_add_(1, prob.head_ids, torch.bmm(
            sq.transpose(1, 2), q[:, :, None])[:, :, 0])
    if prob.tail_c_cols is not None:
        out.scatter_add_(1, prob.tail_c_cols,
                         prob.tail_c_vals * prob.tail_c_vals
                         * torch.gather(q, 1, prob.tail_c_rows))
    elif prob.tail_cols is not None:
        out.scatter_add_(1, prob.tail_cols, prob.tail_vals * prob.tail_vals
                         * torch.gather(q, 1, prob.tail_rows))
    return out


def densify(prob: LRProblem) -> torch.Tensor:
    """Padded sparse rows -> dense (P, R, n) design matrices, for the
    per-item dense-Newton path where n is small."""
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
    (LibLinear.java:317-327)."""
    return gram_batched(densify(prob), _curvature(prob, w),
                        prob.prior_var_inv)


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
