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
and iteration counts equal the JAX solver's. Each loop trip reads
`any(lane condition)` back to the host once.

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


def _trcg(prob: obj.LRProblem, D, g, delta, max_cg_iter: int, lanes):
    """Truncated CG per lane: approximately solve H s = -g within
    ||s|| <= delta (Tron.java:126-179). `lanes` (P,) marks the lanes whose
    outer loop is still running; the others do not hold the loop open.
    Returns (s, r, cg_iters (P,), trips)."""
    P = g.shape[0]
    cgtol = 0.1 * _norm(g)
    s = torch.zeros_like(g)
    r = -g
    d = -g
    rTr = _dot(g, g)
    cg_iter = torch.zeros(P, dtype=torch.int32, device=g.device)
    done = ~lanes
    trips = 0
    while True:
        live = ~done & (cg_iter < max_cg_iter)
        if not bool(live.any()):
            break
        small = _norm(r) <= cgtol

        Hd = obj.hv(prob, D, d)
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
        s = torch.where(bnd2, s_bnd, torch.where(int2, s_try, s))
        r = torch.where(bnd2, r_bnd, torch.where(int2, r_int, r))
        d = torch.where(int2, d_int, d)
        rTr = torch.where(take_int, rTr_new, rTr)
        cg_iter = cg_iter + step.to(torch.int32)
        done = done | (live & (small | take_bnd))
        trips += 1
    return s, r, cg_iter, trips


def tron(prob: obj.LRProblem, w0: torch.Tensor, eps,
         max_iter: int = 1000, max_cg_iter: int = 500) -> TronResult:
    """Minimize the P LR-with-prior objectives from warm starts w0 (P, n).

    eps, a scalar or (P,), is the already class-balance-scaled tolerance
    (the caller applies eps * min(pos,neg)/l, LibLinear.java:309-313)."""
    dtype = w0.dtype
    P = w0.shape[0]
    eps = torch.as_tensor(eps, dtype=dtype, device=w0.device).expand(P)
    # relative-gradient reference point: ||grad at 0|| (Tron.java:47-56)
    gnorm1 = _norm(obj.grad(prob, torch.zeros_like(w0)))

    w = w0
    f = obj.fun(prob, w)
    g, D = obj.grad_and_curvature(prob, w)
    gnorm = _norm(g)
    delta = gnorm
    # 1e-12 in the reference's float64 (Tron.java:117-120); 1e-5 in float32
    stall_rtol = 1e-12 if dtype == torch.float64 else 1e-5

    it = torch.ones(P, dtype=torch.int32, device=w.device)
    cg_total = torch.zeros(P, dtype=torch.int32, device=w.device)
    active = ~(gnorm <= eps * gnorm1)
    trips = cg_trips = 0
    while True:
        lanes = active & (it <= max_iter)
        if not bool(lanes.any()):
            break
        s, r, cg_iter, cg_t = _trcg(prob, D, g, delta, max_cg_iter, lanes)
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
        gnorm = torch.where(accept, _norm(g_new), gnorm)
        it = it + accept.to(torch.int32)
        cg_total = cg_total + torch.where(lanes, cg_iter,
                                          torch.zeros_like(cg_iter))

        # stop conditions (Tron.java:103-121)
        done = accept & (gnorm <= eps * gnorm1)
        done = done | (f < -1.0e32)
        done = done | ((torch.abs(actred) <= 0) & (prered <= 0))
        done = done | ((torch.abs(actred) <= stall_rtol * torch.abs(f))
                       & (torch.abs(prered) <= stall_rtol * torch.abs(f)))
        active = active & ~(done & lanes)
        trips += 1
        cg_trips += cg_t
    return TronResult(w=w, f=f, gnorm=gnorm, iterations=it - 1,
                      cg_iterations=cg_total,
                      converged=gnorm <= eps * gnorm1,
                      newton_trips=trips, cg_trips=cg_trips)


# the JAX package's name for the vmapped solver; here every call is batched
tron_batched = tron
