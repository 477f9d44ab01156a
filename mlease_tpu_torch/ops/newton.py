"""Dense Newton-Cholesky solver for small-dimension problems, batched.

Port of mlease_tpu/ops/newton.py. The per-item trainer fits thousands of
tiny LRs; for those, forming the full weighted Gram H = X' D X + diag(P)
(the hand-written kernel of ops/gram.py on the card) and solving the Newton
system by Cholesky is the direct path, and H is the same Hessian the
reference hands to its Cholesky decomposition for the posterior covariance
(LibLinear.java:317-327). Armijo backtracking keeps global convergence on
the convex objective; the stop rule mirrors TRON's relative-gradient
criterion (Tron.java:56-60), so results are interchangeable with the CG
path.

As in ops/tron.py, the JAX package's vmapped `lax.while_loop`s are written
out as masked lock-step loops over the problem axis P: a lane whose
condition is false keeps its state, so per-lane results and iteration
counts equal the JAX solver's. The factorisation runs in float32 whatever
the solve's dtype and is cast back, as in the JAX solver; in bfloat16 the
step is solved with the float32 factor and rounded to bfloat16 (the JAX
solver rounds the factor and solves in bfloat16, which torch cannot).
`torch.linalg.cholesky_ex` and `torch.cholesky_solve` are library calls, as
the JAX package leaves them to its library outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlease_tpu_torch.ops import objective as obj
from mlease_tpu_torch.ops.gram import gram_batched
from mlease_tpu_torch.ops.segment_sum import accumulate_dtype


class NewtonResult(NamedTuple):
    w: torch.Tensor           # (P, n)
    f: torch.Tensor           # (P,)
    gnorm: torch.Tensor       # (P,)
    iterations: torch.Tensor  # (P,) Newton steps taken per lane
    converged: torch.Tensor   # (P,)
    trips: int = 0            # lock-step trips: one Gram build each


def _norm(a):
    return torch.sqrt((a * a).sum(-1))


def newton_cholesky(prob: obj.LRProblem, w0: torch.Tensor, eps,
                    max_iter: int = 50,
                    max_backtracks: int = 30) -> NewtonResult:
    """Minimize the P LR objectives by damped Newton with dense Cholesky
    solves, from w0 (P, n). Same objective and stop semantics as
    ops/tron.py::tron; meant for problems whose dense dimension is small
    (per-item models)."""
    dtype = w0.dtype
    # torch has no bfloat16 Cholesky solve (neither has the card's cuBLAS a
    # bfloat16 trsm): a bfloat16 solve takes the float32 factor as it is
    # and rounds the step once; float32 and float64 solve in their own type
    solve_dtype = accumulate_dtype(dtype)
    P = w0.shape[0]
    eps = torch.as_tensor(eps, dtype=dtype, device=w0.device).expand(P)
    X = obj.densify(prob)

    gnorm1 = _norm(obj.grad(prob, torch.zeros_like(w0)))
    w = w0
    f = obj.fun(prob, w)
    g = obj.grad(prob, w)
    gnorm = _norm(g)
    it = torch.zeros(P, dtype=torch.int32, device=w.device)
    active = gnorm > eps * gnorm1
    inf = torch.full_like(f, float("inf"))
    nan = torch.full((), float("nan"), dtype=torch.float32, device=w.device)
    trips = 0
    while True:
        lanes = active & (it < max_iter)
        if not bool(lanes.any()):
            break
        # the margins in float32 (ops/objective.py's rule; the dense
        # bfloat16 product is accumulated in float32 and rounded once)
        yz = prob.y * (torch.bmm(X, w[:, :, None])[:, :, 0].to(solve_dtype)
                       + prob.offset)
        p = torch.sigmoid(yz)
        D = (prob.weight * p * (1.0 - p)).to(dtype)
        H = gram_batched(X, D, prob.prior_var_inv)
        # a factorisation that fails gives NaN, which stops its lane below
        L, info = torch.linalg.cholesky_ex(H.to(torch.float32))
        L = torch.where((info != 0)[:, None, None], nan, L).to(solve_dtype)
        s = torch.cholesky_solve(-g[:, :, None].to(solve_dtype),
                                 L)[:, :, 0].to(dtype)
        gs = (g * s).sum(-1)

        # Armijo backtracking: t starts at 2 and halves before every trial
        t = torch.full_like(f, 2.0, dtype=dtype)
        fn = inf
        k = torch.zeros_like(it)
        while True:
            trying = lanes & (fn > f + 1e-4 * t * gs) & (k < max_backtracks)
            if not bool(trying.any()):
                break
            t = torch.where(trying, t * 0.5, t)
            fn = torch.where(trying, obj.fun(prob, w + t[:, None] * s), fn)
            k = k + trying.to(torch.int32)

        improved = lanes & (fn < f)
        w = torch.where(improved[:, None], w + t[:, None] * s, w)
        f = torch.where(improved, fn, f)
        g = torch.where(lanes[:, None], obj.grad(prob, w), g)
        gnorm = torch.where(lanes, _norm(g), gnorm)
        done = (gnorm <= eps * gnorm1) | ~improved
        it = it + lanes.to(torch.int32)
        active = active & ~(done & lanes)
        trips += 1
    return NewtonResult(w=w, f=f, gnorm=gnorm, iterations=it,
                        converged=gnorm <= eps * gnorm1, trips=trips)
