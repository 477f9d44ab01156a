"""Batched trust-region Newton (TRON) solver with warm start.

Port of mlease_tpu/ops/tron.py: liblinear's TRON with the warm-start
modification (Tron.java:30-124 for the outer trust-region loop, :126-179 for
the truncated conjugate-gradient `trcg`; the incoming w is kept and the
relative-gradient stop is measured against ||grad(0)||).

The JAX package writes the solver for one problem and vmaps it;
`jax.vmap` of `lax.while_loop` runs every lane until all are done and
freezes a lane's whole state once its own condition is false. The port is
that masked lock-step solver written out over the problem axis P: every
state tensor carries P, each loop runs while any lane's condition holds,
and a lane whose condition is false keeps its state, so per-lane results
and iteration counts equal the JAX solver's. The loops are split into
functions of a state (`LaneSolver`); `tron` runs them in host loops that
read `any(lane condition)` back once per trip, and the trainers' device
loops (train/admm.py::_SolveLoop: the ADMM lanes solve, naive's lanes
solve and the item trainer's TRON buckets) run the same functions inside a
CUDA graph that loops on the card.

Stopping mirrors the reference: ||g|| <= eps * ||grad(0)||, plus the guard
breaks at Tron.java:108-121 (f < -1e32, non-positive reductions, reductions
negligible relative to |f|; the 1e-12 relative threshold is 1e-5 in
float32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlease_tpu_torch.ops import objective as obj

# Trust-region update constants (Tron.java:31-35)
ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


class TronResult(NamedTuple):
    w: torch.Tensor              # (P, n) solutions
    f: torch.Tensor              # (P,) final objective values
    gnorm: torch.Tensor          # (P,) final gradient norms
    iterations: torch.Tensor     # (P,) accepted Newton iterations
    cg_iterations: torch.Tensor  # (P,) total CG iterations
    converged: torch.Tensor      # (P,) reached ||g|| <= eps*||g0||
    # lock-step loop trips, each a pass over all P problems' data
    newton_trips: int = 0
    cg_trips: int = 0


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt((a * a).sum(-1))


def _safe_div(num, den, ok):
    """num / den where `ok`, else 0: the guarded divisions of the JAX
    solver, jnp.where(ok, num / where(ok, den, 1), 0)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


class LaneState(NamedTuple):
    """The Newton loop's carried state, every field (P, ...) on the device:
    w, g, D (P, n); f, gnorm, gnorm1, eps, delta (P,); it (P,) int32
    (accepted Newton iterations + 1), cg_total (P,) int32, active (P,);
    trips, cg_trips (0-d int64) the lock-step Newton and CG trips."""

    w: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    D: torch.Tensor
    gnorm: torch.Tensor
    gnorm1: torch.Tensor
    eps: torch.Tensor
    delta: torch.Tensor
    it: torch.Tensor
    cg_total: torch.Tensor
    active: torch.Tensor
    trips: torch.Tensor
    cg_trips: torch.Tensor


class LaneCgState(NamedTuple):
    """One Newton trip's truncated-CG state (Tron.java:126-179): s, r, d
    (P, n); rTr, cgtol (P,); cg_iter (P,) int32; done (P,); lanes (P,) the
    lanes whose Newton loop runs this trip (the others start done and hold
    nothing open); it (0-d int64) the trip's lock-step CG trips so far."""

    s: torch.Tensor
    r: torch.Tensor
    d: torch.Tensor
    rTr: torch.Tensor
    cgtol: torch.Tensor
    cg_iter: torch.Tensor
    done: torch.Tensor
    lanes: torch.Tensor
    it: torch.Tensor


class LaneSolver:
    """`tron`'s two loops as functions of a state, as ops/tron_multi.py's
    MultiSolver splits tron_multi, so that the eager solve and the device
    loop of AdmmTrainer.run_fused run the same ops: `init`, `running`,
    `cg_init`, `cg_open`, `cg_trip` (one trip of the CG loop) and
    `epilogue` (the Newton step and the stop guards of Tron.java:79-121).
    None of them reads the device from the host."""

    def __init__(self, prob: obj.LRProblem, max_iter: int = 1000,
                 max_cg_iter: int = 500):
        self.prob = prob
        self.max_iter, self.max_cg_iter = max_iter, max_cg_iter

    def init(self, w0: torch.Tensor, eps) -> LaneState:
        prob, dtype, P = self.prob, w0.dtype, w0.shape[0]
        eps = torch.as_tensor(eps, dtype=dtype, device=w0.device).expand(P)
        # relative-gradient reference point: ||grad at 0|| (Tron.java:47-56)
        gnorm1 = _norm(obj.grad(prob, torch.zeros_like(w0)))
        f = obj.fun(prob, w0)
        g, D = obj.grad_and_curvature(prob, w0)
        gnorm = _norm(g)
        zero = torch.zeros((), dtype=torch.int64, device=w0.device)
        return LaneState(
            w=w0, f=f, g=g, D=D, gnorm=gnorm, gnorm1=gnorm1, eps=eps,
            delta=gnorm,
            it=torch.ones(P, dtype=torch.int32, device=w0.device),
            cg_total=torch.zeros(P, dtype=torch.int32, device=w0.device),
            active=~(gnorm <= eps * gnorm1), trips=zero,
            cg_trips=zero.clone())

    def running(self, st: LaneState) -> torch.Tensor:
        """(P,): the lanes whose Newton loop takes another trip."""
        return st.active & (st.it <= self.max_iter)

    # -- the CG loop ------------------------------------------------------
    def cg_init(self, st: LaneState, lanes: torch.Tensor) -> LaneCgState:
        g = st.g
        return LaneCgState(
            s=torch.zeros_like(g), r=-g, d=-g, rTr=_dot(g, g),
            cgtol=0.1 * _norm(g),
            cg_iter=torch.zeros(g.shape[0], dtype=torch.int32,
                                device=g.device),
            done=~lanes, lanes=lanes,
            it=torch.zeros((), dtype=torch.int64, device=g.device))

    def _live(self, cs: LaneCgState) -> torch.Tensor:
        return ~cs.done & (cs.cg_iter < self.max_cg_iter)

    def cg_open(self, cs: LaneCgState) -> torch.Tensor:
        """0-d bool: the CG loop takes another trip."""
        return self._live(cs).any()

    def cg_trip(self, st: LaneState, cs: LaneCgState) -> LaneCgState:
        s, r, d, rTr = cs.s, cs.r, cs.d, cs.rTr
        delta = st.delta
        live = self._live(cs)
        small = _norm(r) <= cs.cgtol

        Hd = obj.hv(self.prob, st.D, d)
        dHd = _dot(d, Hd)
        alpha = _safe_div(rTr, dHd, dHd > 0)
        s_try = s + alpha[:, None] * d
        boundary = _norm(s_try) > delta

        # boundary case: back to s, then on to the trust boundary
        # (Tron.java:146-162)
        std = _dot(s, d)
        sts = _dot(s, s)
        dtd = _dot(d, d)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
        denom_pos = std + rad
        alpha_b = torch.where(std >= 0,
                              _safe_div(dsq - sts, denom_pos, denom_pos != 0),
                              _safe_div(rad - std, dtd, dtd != 0))
        s_bnd = s + alpha_b[:, None] * d
        r_bnd = r - alpha_b[:, None] * Hd

        # interior case: the normal CG update (Tron.java:163-172)
        r_int = r - alpha[:, None] * Hd
        rTr_new = _dot(r_int, r_int)
        beta = _safe_div(rTr_new, rTr, rTr > 0)
        d_int = r_int + beta[:, None] * d

        step = live & ~small
        take_bnd = step & boundary
        take_int = step & ~boundary
        bnd2, int2 = take_bnd[:, None], take_int[:, None]
        return cs._replace(
            s=torch.where(bnd2, s_bnd, torch.where(int2, s_try, s)),
            r=torch.where(bnd2, r_bnd, torch.where(int2, r_int, r)),
            d=torch.where(int2, d_int, d),
            rTr=torch.where(take_int, rTr_new, rTr),
            cg_iter=cs.cg_iter + step.to(torch.int32),
            done=cs.done | (live & (small | take_bnd)), it=cs.it + 1)

    # -- the Newton step after the CG loop --------------------------------
    def epilogue(self, st: LaneState, cs: LaneCgState) -> LaneState:
        prob, lanes = self.prob, cs.lanes
        w, f, g, D, delta, it = st.w, st.f, st.g, st.D, st.delta, st.it
        s, r, cg_iter = cs.s, cs.r, cs.cg_iter
        w_new = w + s
        gs = _dot(g, s)
        prered = -0.5 * (gs - _dot(s, r))
        fnew = obj.fun(prob, w_new)
        actred = f - fnew
        snorm = _norm(s)

        # first-iteration shrink of the initial step bound (Tron.java:79)
        delta_s = torch.where(it == 1, torch.minimum(delta, snorm), delta)

        denom = fnew - f - gs
        alpha = torch.where(
            denom <= 0, torch.full_like(denom, SIGMA3),
            torch.clamp(-0.5 * (gs / torch.where(denom <= 0,
                                                 torch.ones_like(denom),
                                                 denom)), min=SIGMA1))
        # trust region radius update ladder (Tron.java:88-96)
        asn = alpha * snorm
        delta_new = torch.where(
            actred < ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm,
                          SIGMA2 * delta_s),
            torch.where(
                actred < ETA1 * prered,
                torch.maximum(SIGMA1 * delta_s,
                              torch.minimum(asn, SIGMA2 * delta_s)),
                torch.where(
                    actred < ETA2 * prered,
                    torch.maximum(SIGMA1 * delta_s,
                                  torch.minimum(asn, SIGMA3 * delta_s)),
                    torch.maximum(delta_s,
                                  torch.minimum(asn, SIGMA3 * delta_s)))))
        delta = torch.where(lanes, delta_new.to(delta.dtype), delta)

        accept = lanes & (actred > ETA0 * prered)
        acc2 = accept[:, None]
        g_new, D_new = obj.grad_and_curvature(prob, w_new)
        w = torch.where(acc2, w_new, w)
        f = torch.where(accept, fnew, f)
        g = torch.where(acc2, g_new, g)
        D = torch.where(acc2, D_new, D)
        gnorm = torch.where(accept, _norm(g_new), st.gnorm)
        it = it + accept.to(torch.int32)
        cg_total = st.cg_total + torch.where(lanes, cg_iter,
                                             torch.zeros_like(cg_iter))

        # stop conditions (Tron.java:103-121); 1e-12 in the reference's
        # float64 (Tron.java:117-120), 1e-5 in float32
        stall_rtol = 1e-12 if w.dtype == torch.float64 else 1e-5
        done = accept & (gnorm <= st.eps * st.gnorm1)
        done = done | (f < -1.0e32)
        done = done | ((torch.abs(actred) <= 0) & (prered <= 0))
        done = done | ((torch.abs(actred) <= stall_rtol * torch.abs(f))
                       & (torch.abs(prered) <= stall_rtol * torch.abs(f)))
        return st._replace(w=w, f=f, g=g, D=D, gnorm=gnorm, delta=delta,
                           it=it, cg_total=cg_total,
                           active=st.active & ~(done & lanes),
                           trips=st.trips + 1, cg_trips=st.cg_trips + cs.it)

    def lockstep_trips(self, st: LaneState) -> torch.Tensor:
        """(2,) int64 on the device: the lock-step Newton and CG trips."""
        return torch.stack([st.trips, st.cg_trips])

    def result(self, st: LaneState) -> TronResult:
        """The solve's result, with the trip counters read to the host."""
        trips, cg_trips = self.lockstep_trips(st).tolist()
        return TronResult(w=st.w, f=st.f, gnorm=st.gnorm,
                          iterations=st.it - 1, cg_iterations=st.cg_total,
                          converged=st.gnorm <= st.eps * st.gnorm1,
                          newton_trips=trips, cg_trips=cg_trips)


def tron(prob: obj.LRProblem, w0: torch.Tensor, eps,
         max_iter: int = 1000, max_cg_iter: int = 500) -> TronResult:
    """Minimize the P LR-with-prior objectives from warm starts w0 (P, n).

    eps, a scalar or (P,), is the already class-balance-scaled tolerance
    (the caller applies eps * min(pos,neg)/l, LibLinear.java:309-313).
    The loops run on the host over LaneSolver's functions: one read of
    "any lane open" per CG trip and per Newton trip (the state counts the
    trips, read once at the end)."""
    solver = LaneSolver(prob, max_iter, max_cg_iter)
    st = solver.init(w0, eps)
    while True:
        lanes = solver.running(st)
        if not bool(lanes.any()):
            break
        cs = solver.cg_init(st, lanes)
        while bool(solver.cg_open(cs)):
            cs = solver.cg_trip(st, cs)
        st = solver.epilogue(st, cs)
    return solver.result(st)


# the JAX package's name for the vmapped solver; here every call is batched
tron_batched = tron
