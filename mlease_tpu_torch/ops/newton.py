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
counts equal the JAX solver's. The loops are split into functions of a
state (`NewtonSolver`: the Newton step, one Armijo trial, the Newton
finish); `newton_cholesky` runs them in host loops that read "any lane
open" once per trip, and the item trainer's device loop
(train/item.py::_NewtonLoop) runs the same functions inside a CUDA graph
that loops on the card. The factorisation runs in float32 whatever the
solve's dtype and is cast back, as in the JAX solver; in bfloat16 the step
is solved with the float32 factor and rounded to bfloat16 (the JAX solver
rounds the factor and solves in bfloat16, which torch cannot).
`torch.linalg.cholesky_ex` and the two `torch.linalg.solve_triangular`s
are library calls, as the JAX package leaves them to its library outside
any kernel; not `torch.cholesky_solve`, which torch gives to MAGMA for a
batch on the card, and MAGMA allocates inside the call, which a CUDA graph
cannot capture (ops/tron_multi.py::_head_solve).

The problem may share its data over lanes (ops/objective.py: data blocks
(B, ...), lanes P = L*B, the item trainer's (grid x item) batch): the
dense design matrix is then made once per block and copied to the L lanes
once, when the solver is made, for the per-lane products and Gram matrices.
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


class NewtonState(NamedTuple):
    """The Newton loop's carried state, every field on the device: w, g
    (P, n); f, gnorm, gnorm1, eps (P,); it (P,) int32 Newton steps taken;
    active (P,); trips (0-d int64) the lock-step Newton trips."""

    w: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    gnorm: torch.Tensor
    gnorm1: torch.Tensor
    eps: torch.Tensor
    it: torch.Tensor
    active: torch.Tensor
    trips: torch.Tensor


class NewtonStep(NamedTuple):
    """One Newton trip's step and its Armijo backtrack: s (P, n) the
    Cholesky step, gs (P,) g's; t, fn (P,) the trial step length and its
    objective; k (P,) int32 the trials made; lanes (P,) the lanes whose
    Newton loop runs this trip."""

    s: torch.Tensor
    gs: torch.Tensor
    t: torch.Tensor
    fn: torch.Tensor
    k: torch.Tensor
    lanes: torch.Tensor


def _norm(a):
    return torch.sqrt((a * a).sum(-1))


class NewtonSolver:
    """`newton_cholesky`'s two loops as functions of a state, as
    ops/tron.py's LaneSolver splits tron: `init`, `running` (the lanes
    whose Newton loop takes another trip), `step` (the margins, the
    curvature D, H through K2's gram_batched, the float32 Cholesky factor
    with a failed one turned to NaN, the step from two triangular solves,
    and t = 2), `bt_open` and `bt_trip` (one Armijo trial) and `finish`
    (accept, gradient and stop test). None of them reads the device from
    the host."""

    def __init__(self, prob: obj.LRProblem, max_iter: int = 50,
                 max_backtracks: int = 30):
        self.prob = prob
        self.max_iter, self.max_backtracks = max_iter, max_backtracks
        X = obj.densify(prob)                            # (B, R, n)
        lanes = prob.prior_mean.shape[0] // X.shape[0]
        self.X = X.repeat(lanes, 1, 1) if lanes > 1 else X

    def init(self, w0: torch.Tensor, eps) -> NewtonState:
        prob, P = self.prob, w0.shape[0]
        eps = torch.as_tensor(eps, dtype=w0.dtype, device=w0.device).expand(P)
        gnorm1 = _norm(obj.grad(prob, torch.zeros_like(w0)))
        g = obj.grad(prob, w0)
        gnorm = _norm(g)
        return NewtonState(
            w=w0, f=obj.fun(prob, w0), g=g, gnorm=gnorm, gnorm1=gnorm1,
            eps=eps, it=torch.zeros(P, dtype=torch.int32, device=w0.device),
            active=gnorm > eps * gnorm1,
            trips=torch.zeros((), dtype=torch.int64, device=w0.device))

    def running(self, st: NewtonState) -> torch.Tensor:
        """(P,): the lanes whose Newton loop takes another trip."""
        return st.active & (st.it < self.max_iter)

    def step(self, st: NewtonState, lanes: torch.Tensor) -> NewtonStep:
        prob, w, g, dtype = self.prob, st.w, st.g, st.w.dtype
        # torch has no bfloat16 Cholesky solve (neither has the card's
        # cuBLAS a bfloat16 trsm): a bfloat16 solve takes the float32
        # factor as it is and rounds the step once; float32 and float64
        # solve in their own type
        solve_dtype = accumulate_dtype(dtype)
        # the margins in float32 (ops/objective.py's rule; the dense
        # bfloat16 product is accumulated in float32 and rounded once)
        m = torch.bmm(self.X, w[:, :, None])[:, :, 0].to(solve_dtype)
        m3 = m.view(-1, *prob.y.shape)
        p = torch.sigmoid(prob.y * (m3 + prob.offset))
        D = (prob.weight * p * (1.0 - p)).to(dtype).view(m.shape)
        H = gram_batched(self.X, D, prob.prior_var_inv)
        # a factorisation that fails gives NaN, which stops its lane in
        # `finish`
        L, info = torch.linalg.cholesky_ex(H.to(torch.float32))
        nan = torch.full((), float("nan"), dtype=torch.float32,
                         device=w.device)
        L = torch.where((info != 0)[:, None, None], nan, L).to(solve_dtype)
        y = torch.linalg.solve_triangular(
            L, -g[:, :, None].to(solve_dtype), upper=False)
        s = torch.linalg.solve_triangular(L.mT, y,
                                          upper=True)[:, :, 0].to(dtype)
        # Armijo backtracking: t starts at 2 and halves before every trial
        return NewtonStep(s=s, gs=(g * s).sum(-1),
                          t=torch.full_like(st.f, 2.0, dtype=dtype),
                          fn=torch.full_like(st.f, float("inf")),
                          k=torch.zeros_like(st.it), lanes=lanes)

    def _trying(self, st: NewtonState, bs: NewtonStep) -> torch.Tensor:
        return (bs.lanes & (bs.fn > st.f + 1e-4 * bs.t * bs.gs)
                & (bs.k < self.max_backtracks))

    def bt_open(self, st: NewtonState, bs: NewtonStep) -> torch.Tensor:
        """0-d bool: the backtrack takes another trial."""
        return self._trying(st, bs).any()

    def bt_trip(self, st: NewtonState, bs: NewtonStep) -> NewtonStep:
        trying = self._trying(st, bs)
        t = torch.where(trying, bs.t * 0.5, bs.t)
        fn = torch.where(trying, obj.fun(self.prob, st.w + t[:, None] * bs.s),
                         bs.fn)
        return bs._replace(t=t, fn=fn, k=bs.k + trying.to(torch.int32))

    def finish(self, st: NewtonState, bs: NewtonStep) -> NewtonState:
        lanes = bs.lanes
        improved = lanes & (bs.fn < st.f)
        w = torch.where(improved[:, None], st.w + bs.t[:, None] * bs.s, st.w)
        f = torch.where(improved, bs.fn, st.f)
        g = torch.where(lanes[:, None], obj.grad(self.prob, w), st.g)
        gnorm = torch.where(lanes, _norm(g), st.gnorm)
        done = (gnorm <= st.eps * st.gnorm1) | ~improved
        return st._replace(w=w, f=f, g=g, gnorm=gnorm,
                           it=st.it + lanes.to(torch.int32),
                           active=st.active & ~(done & lanes),
                           trips=st.trips + 1)

    def result(self, st: NewtonState) -> NewtonResult:
        """The solve's result, with the trip counter read to the host."""
        return NewtonResult(w=st.w, f=st.f, gnorm=st.gnorm,
                            iterations=st.it,
                            converged=st.gnorm <= st.eps * st.gnorm1,
                            trips=int(st.trips))


def newton_cholesky(prob: obj.LRProblem, w0: torch.Tensor, eps,
                    max_iter: int = 50,
                    max_backtracks: int = 30) -> NewtonResult:
    """Minimize the P LR objectives by damped Newton with dense Cholesky
    solves, from w0 (P, n). Same objective and stop semantics as
    ops/tron.py::tron; meant for problems whose dense dimension is small
    (per-item models). The loops run on the host over NewtonSolver's
    functions: one read of "any lane open" per Newton trip and per Armijo
    trial."""
    solver = NewtonSolver(prob, max_iter, max_backtracks)
    st = solver.init(w0, eps)
    while True:
        lanes = solver.running(st)
        if not bool(lanes.any()):
            break
        bs = solver.step(st, lanes)
        while bool(solver.bt_open(st, bs)):
            bs = solver.bt_trip(st, bs)
        st = solver.finish(st, bs)
    return solver.result(st)
