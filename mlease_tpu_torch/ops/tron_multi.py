"""Multi-RHS TRON: the whole lambda path solved in one pass over the data.

Port of the lanes-major solver of mlease_tpu/ops/tron_multi.py: the same
algorithm (Tron.java:30-179 with the warm-start modification, run
independently per lambda lane), the same lock-step trip counting and the
same masked per-lane updates. All trust-region scalars (f, delta, ||g||,
accept/reject) are (L,) tensors; the JAX package's `lax.while_loop`s become
host loops whose condition (`any(active)`) is read back once per trip.

Internally the state is lanes-major, (L, n) and (L, R); the public contract
is the JAX one, (n, L) in and (n, L) out. Each sorted sparse-tail reduce is
one call of `ops.segment_sum.segment_sum_gather`, the hand-written kernel on
the card that gathers, weights and reduces the tail into the pass's output
in place (no size gate: every sorted-tail reduce takes it); the ELL and
unsorted tail scatters use `index_add_`, as XLA's scatter does.

precondition="head_block" solves the dense-head curvature block exactly:
its (L, H, H) build is the weighted-Gram kernel of ops/gram.py with one
shared X and L weight vectors. Not ported yet: the lanes-minor pass
functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlease_tpu_torch.ops.gram import gram_batched
from mlease_tpu_torch.ops.segment_sum import segment_sum_gather

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


def stack_blocks(indices, values, y, weight, offset, head,
                 prior_mean, rho_eff) -> MultiProblem:
    """Fold B batched blocks into ONE flat MultiProblem (flat-blocks form).

    indices/values are (B, R, K); y/weight/offset (B, R); `head` the 8-tuple
    of hybrid arrays (all (B, ...) or None); prior_mean (L, B, n); rho_eff
    (L,). Per-block sorted tails stay globally sorted because block-major
    offsets are monotone; this is checked here, once, together with the id
    ranges of both streams, since the sorted-stream kernel relies on both."""
    (head_x, head_ids, t_rows, t_cols, t_vals,
     tc_rows, tc_cols, tc_vals) = head
    B, R, K = indices.shape
    n = prior_mean.shape[2]
    if B * n >= 2**31 or B * R >= 2**31:
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
    return with_prior(prob, prior_mean, rho_eff)


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


def _xv_lm(prob: MultiProblem, V: torch.Tensor) -> torch.Tensor:
    """(L, n) -> (L, R) scores."""
    R = prob.y.shape[0]
    L = V.shape[0]
    if prob.indices.shape[-1] > 0:
        out = (prob.values[None] * V[:, prob.indices]).sum(-1)
    else:
        out = torch.zeros((L, R), dtype=V.dtype, device=V.device)
    if prob.head_x is not None:
        hx = prob.head_x
        hw = V[:, prob.head_ids]                    # (L, H) | (L, B*H)
        if hx.dim() == 3 and hx.dtype == V.dtype:   # flat-blocks head
            B, Rb, H = hx.shape
            prod = torch.bmm(hx, hw.reshape(L, B, H).permute(1, 2, 0))
            out = out + prod.permute(2, 0, 1).reshape(L, R)  # (B, Rb, L)
        elif hx.dim() == 3:                         # narrow head: by block
            B, Rb, H = hx.shape
            hwb = hw.reshape(L, B, H)
            outb = out.view(L, B, Rb)           # out is this pass's own
            for b in range(B):
                outb[:, b] += hwb[:, b] @ _widen(hx[b], V.dtype).T
        else:
            out = out + hw @ _widen(hx, V.dtype).T
    if prob.tail_cols is not None:
        segment_sum_gather(prob.tail_vals, V, prob.tail_cols, prob.tail_rows,
                           R, out=out)
    return out


def _xtv_lm(prob: MultiProblem, D: torch.Tensor) -> torch.Tensor:
    """(L, R) -> (L, n) accumulation."""
    n = prob.prior_mean.shape[-1]
    L = D.shape[0]
    out = torch.zeros((L, n), dtype=D.dtype, device=D.device)
    if prob.indices.shape[-1] > 0:
        out.index_add_(1, prob.indices.reshape(-1),
                       (prob.values[None] * D[:, :, None]).reshape(L, -1))
    if prob.head_x is not None:
        out.index_add_(1, prob.head_ids, _head_t(prob.head_x, D))
    if prob.tail_c_cols is not None:
        segment_sum_gather(prob.tail_c_vals, D, prob.tail_c_rows,
                           prob.tail_c_cols, n, out=out)
    elif prob.tail_cols is not None:
        out = out + torch.zeros_like(out).index_add_(
            1, prob.tail_cols, prob.tail_vals[None, :] * D[:, prob.tail_rows])
    return out


def _xtv_and_sqdiag_lm(prob: MultiProblem, C: torch.Tensor,
                       Dm: torch.Tensor):
    """(X'C, (X∘X)'Dm) with the 2L lanes stacked, so every nonzero's id and
    value are read once for both."""
    n = prob.prior_mean.shape[-1]
    L = C.shape[0]
    out = torch.zeros((2 * L, n), dtype=C.dtype, device=C.device)
    if prob.indices.shape[-1] > 0:
        v = prob.values[None]
        contrib = torch.cat([v * C[:, :, None], (v * v) * Dm[:, :, None]])
        out.index_add_(1, prob.indices.reshape(-1),
                       contrib.reshape(2 * L, -1))
    if prob.head_x is not None:
        hx = prob.head_x
        out.index_add_(1, prob.head_ids,
                       torch.cat([_head_t(hx, C),
                                  _head_t(hx, Dm, square=True)]))
    CD = torch.cat([C, Dm])
    if prob.tail_c_cols is not None:
        segment_sum_gather(prob.tail_c_vals, CD, prob.tail_c_rows,
                           prob.tail_c_cols, n, out=out, square_from=L)
    elif prob.tail_cols is not None:
        tv = prob.tail_vals[None, :]
        rows = CD[:, prob.tail_rows]
        contrib = torch.cat([tv * rows[:L], (tv * tv) * rows[L:]])
        out = out + torch.zeros_like(out).index_add_(1, prob.tail_cols,
                                                     contrib)
    return out[:L], out[L:]


def _softplus_neg(yz: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-yz)), exactly as jnp.logaddexp(0, -yz)."""
    return torch.logaddexp(yz.new_zeros(()), -yz)


def _fun_grad_curvature_lm(prob: MultiProblem, W: torch.Tensor,
                           with_diag: bool = False):
    """Objective + gradient + curvature (+ Jacobi diagonal) sharing ONE
    scores pass."""
    yz = prob.y[None, :] * (_xv_lm(prob, W) + prob.offset[None, :])
    dw = W - prob.prior_mean
    F = ((prob.weight[None, :] * _softplus_neg(yz)).sum(1)
         + 0.5 * (dw * dw * prob.prior_var_inv).sum(1))
    p = torch.sigmoid(yz)
    coeff = prob.weight[None, :] * (p - 1.0) * prob.y[None, :]
    Dm = prob.weight[None, :] * p * (1.0 - p)
    if with_diag:
        Gd, Hd = _xtv_and_sqdiag_lm(prob, coeff, Dm)
        return (F, Gd + dw * prob.prior_var_inv, Dm,
                Hd + prob.prior_var_inv)
    G = _xtv_lm(prob, coeff) + dw * prob.prior_var_inv
    return F, G, Dm


def _grad_norm_at_zero_lm(prob: MultiProblem, n_rhs: int) -> torch.Tensor:
    """||grad at W=0|| per lane in one X'v pass (Xv(0) == 0 exactly)."""
    yz = prob.y[None, :] * prob.offset[None, :].expand(
        n_rhs, prob.y.shape[0]).to(prob.prior_mean.dtype)
    p = torch.sigmoid(yz)
    coeff = prob.weight[None, :] * (p - 1.0) * prob.y[None, :]
    G0 = _xtv_lm(prob, coeff) - prob.prior_mean * prob.prior_var_inv
    return _norm_lm(G0)


def _hv_lm(prob: MultiProblem, Dm: torch.Tensor,
           S: torch.Tensor) -> torch.Tensor:
    return _xtv_lm(prob, Dm * _xv_lm(prob, S)) + S * prob.prior_var_inv


def _dot_lm(a, b):
    return (a * b).sum(1)                     # (L,)


def _norm_lm(a):
    return torch.sqrt((a * a).sum(1))


class HeadBlockPrecond(NamedTuple):
    """M = (exact dense-head Hessian block) + (Jacobi diagonal on the tail).

    On power-law data the head columns carry most of the curvature mass, so
    preconditioning CG with the head block solved exactly (one (L, H, H)
    Cholesky per Newton trip) plus the Jacobi diagonal elsewhere cuts CG
    trips against the diagonal alone. Any SPD M preserves TRON's convergence
    guarantees; the outer ||g|| stop rule is unchanged. Lanes-major, like
    the rest of the solver's state (the JAX package keeps diag as (n, L))."""

    chol: torch.Tensor       # (L, H, H) lower Cholesky factors per lane
    diag: torch.Tensor       # (L, n) Jacobi diagonal; entries at head_ids
                             # are set to 1 and overridden by the block solve
    head_mask: torch.Tensor  # (1, n) 1.0 at head coordinates
    head_ids: torch.Tensor   # (H,)


def build_head_precond(prob: MultiProblem, Dm: torch.Tensor,
                       Hdiag: torch.Tensor) -> HeadBlockPrecond:
    """Head block A_l = head_x' diag(Dm_l) head_x + diag(pvi_head_l), with
    prob's priors, Dm (L, R) and Hdiag (L, n) lanes-major.

    The (L, H, H) build is the weighted-Gram kernel with head_x shared by
    the L lanes, in the solve's own type (the JAX package builds it in the
    TPU's default bf16 matmul precision, because it only shapes a
    preconditioner); the Cholesky runs in float32. Hdiag is the full Jacobi
    diagonal of the fused f/g/D + diag pass (its head entries are replaced,
    not reused)."""
    dtype = Hdiag.dtype
    ids = prob.head_ids.long()
    A = gram_batched(_widen(prob.head_x, dtype), Dm,
                     prob.prior_var_inv[:, ids])
    chol = torch.linalg.cholesky_ex(A.to(torch.float32))[0].to(dtype)
    head_mask = torch.zeros((1, Hdiag.shape[1]), dtype=dtype,
                            device=Hdiag.device)
    head_mask[0, ids] = 1.0
    diag = torch.where(head_mask > 0, torch.ones_like(Hdiag),
                       torch.clamp(Hdiag, min=1e-12))
    return HeadBlockPrecond(chol=chol, diag=diag, head_mask=head_mask,
                            head_ids=ids)


def _head_solve(pc: HeadBlockPrecond, r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r, (L, n): cholesky_solve on the head coordinates, a divide
    on the tail."""
    sol = torch.cholesky_solve(r[:, pc.head_ids][:, :, None], pc.chol)
    out = r / pc.diag
    out[:, pc.head_ids] = sol[:, :, 0]
    return out


def _head_apply(pc: HeadBlockPrecond, v: torch.Tensor) -> torch.Tensor:
    """M v, (L, n) (for the M-norm trust-region dots)."""
    v_head = v[:, pc.head_ids][:, :, None]
    Av = torch.bmm(pc.chol, torch.bmm(pc.chol.transpose(1, 2), v_head))
    out = v * pc.diag * (1.0 - pc.head_mask)
    out[:, pc.head_ids] = Av[:, :, 0]
    return out


class MultiTronResult(NamedTuple):
    w: torch.Tensor            # (n, L)
    f: torch.Tensor            # (L,)
    gnorm: torch.Tensor        # (L,)
    iterations: torch.Tensor   # (L,) accepted Newton steps per lane
    converged: torch.Tensor    # (L,)
    # lock-step loop-trip counters: every trip is a full pass over the
    # block's data serving all L lanes, however many lanes are still active
    newton_trips: int = 0
    cg_trips: int = 0


def _safe_div(num, den, ok):
    """num / den where `ok`, else 0 (jnp.where(ok, num/where(ok,den,1), 0))."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _trcg(prob: MultiProblem, Dm, G, delta, max_cg_iter: int,
          M: torch.Tensor | HeadBlockPrecond | None = None):
    """Per-lane truncated CG with lock-step data passes (Tron.java:126-179).

    M None reproduces the reference; an (L, n) Jacobi diagonal or a
    HeadBlockPrecond measures the trust region in the M-norm and tests the
    residual in ||r||_{M^-1}."""
    if M is None:
        def precond(r):
            return r

        def mdot(a, b):
            return _dot_lm(a, b)
    elif isinstance(M, HeadBlockPrecond):
        def precond(r):
            return _head_solve(M, r)

        def mdot(a, b):
            return (a * _head_apply(M, b)).sum(1)
    else:
        def precond(r):
            return r / M

        def mdot(a, b):
            return (a * M * b).sum(1)

    z = precond(-G)
    rz = _dot_lm(-G, z)
    cgtol = 0.1 * torch.sqrt(rz)
    s, r, d = torch.zeros_like(G), -G, z
    done = torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    it = 0
    while it < max_cg_iter and bool((~done).any()):
        small = torch.sqrt(torch.clamp(_dot_lm(r, z), min=0.0)) <= cgtol

        Hd = _hv_lm(prob, Dm, d)
        dHd = _dot_lm(d, Hd)
        alpha = _safe_div(rz, dHd, dHd > 0)
        s_try = s + alpha[:, None] * d
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

        s_bnd = s + alpha_b[:, None] * d
        r_bnd = r - alpha_b[:, None] * Hd
        r_int = r - alpha[:, None] * Hd
        z_int = precond(r_int)
        rz_new = _dot_lm(r_int, z_int)
        beta = _safe_div(rz_new, rz, rz > 0)
        d_int = z_int + beta[:, None] * d

        step = ~small & ~done
        take_bnd = step & boundary
        take_int = step & ~boundary
        bnd2, int2 = take_bnd[:, None], take_int[:, None]
        s = torch.where(bnd2, s_bnd, torch.where(int2, s_try, s))
        r = torch.where(bnd2, r_bnd, torch.where(int2, r_int, r))
        z = torch.where(int2, z_int, z)
        d = torch.where(int2, d_int, d)
        rz = torch.where(take_int, rz_new, rz)
        done = done | small | take_bnd
        it += 1
    snorm = torch.sqrt(torch.clamp(mdot(s, s), min=0.0))
    return s, r, snorm, it


def tron_multi(prob: MultiProblem, W0: torch.Tensor, eps,
               max_iter: int = 1000, max_cg_iter: int = 500,
               precondition=False) -> MultiTronResult:
    """Warm-started TRON over L simultaneous lambda-problems (Tron.java:30-124
    per lane; stall thresholds as in mlease_tpu/ops/tron.py).

    precondition=True or "jacobi" runs the Jacobi-preconditioned CG with an
    M-norm trust region; "head_block" also solves the dense-head curvature
    block exactly (HeadBlockPrecond; it needs the hybrid layout, one block);
    False or "none" the reference CG. The outer stop rule (euclidean
    ||g|| <= eps*||g0||) is the same for all."""
    dtype = W0.dtype
    L = W0.shape[1]
    eps = torch.as_tensor(eps, dtype=dtype, device=W0.device).expand(L)
    kind = {False: "none", True: "jacobi"}.get(precondition, precondition)
    if kind not in ("none", "jacobi", "head_block"):
        raise ValueError(
            f"precondition must be False/True/'jacobi'/'head_block'; "
            f"got {precondition!r}")
    if kind == "head_block" and (prob.head_x is None
                                 or prob.head_x.dim() == 3):
        raise ValueError("head_block preconditioning needs the hybrid "
                         "dense-head layout (head_size > 0, non-flat)")

    # lanes-major inside: one transpose of the (n, L) inputs per solve
    prob = prob._replace(
        prior_mean=prob.prior_mean.T.contiguous(),
        prior_var_inv=torch.broadcast_to(
            prob.prior_var_inv, prob.prior_mean.shape).T.contiguous())
    W = W0.T.contiguous()

    gnorm1 = _grad_norm_at_zero_lm(prob, L)
    if kind == "head_block":
        F, G, Dm, Hd0 = _fun_grad_curvature_lm(prob, W, with_diag=True)
        M = build_head_precond(prob, Dm, Hd0)
        gnorm = _norm_lm(G)
        delta = torch.sqrt(_dot_lm(G, _head_solve(M, G)))
    elif kind == "jacobi":
        F, G, Dm, Hd0 = _fun_grad_curvature_lm(prob, W, with_diag=True)
        M = torch.clamp(Hd0, min=1e-12)
        gnorm = _norm_lm(G)
        delta = torch.sqrt(_dot_lm(G, G / M))
    else:
        F, G, Dm = _fun_grad_curvature_lm(prob, W)
        M = None
        gnorm = _norm_lm(G)
        delta = gnorm
    stall_rtol = 1e-12 if dtype == torch.float64 else 1e-5

    it = torch.ones(L, dtype=torch.int32, device=W.device)
    active = gnorm > eps * gnorm1
    trips = cg_trips = 0
    while bool((active & (it <= max_iter)).any()):
        S, Rres, snorm, cg_it = _trcg(prob, Dm, G, delta, max_cg_iter, M)
        W_new = W + S
        gs = _dot_lm(G, S)
        prered = -0.5 * (gs - _dot_lm(S, Rres))
        # one fused data pass yields f/g/D (+ diag) at the trial point; the
        # accept select below discards them on rejection
        if kind == "head_block":
            F_new, G_new, Dm_new, Hd_new = _fun_grad_curvature_lm(
                prob, W_new, with_diag=True)
            M_new = build_head_precond(prob, Dm_new, Hd_new)
        elif kind == "jacobi":
            F_new, G_new, Dm_new, Hd_new = _fun_grad_curvature_lm(
                prob, W_new, with_diag=True)
            M_new = torch.clamp(Hd_new, min=1e-12)
        else:
            F_new, G_new, Dm_new = _fun_grad_curvature_lm(prob, W_new)
        actred = F - F_new

        delta = torch.where(it == 1, torch.minimum(delta, snorm), delta)
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
        delta = torch.where(active, delta_new, delta)

        accept = active & (actred > ETA0 * prered)
        acc2 = accept[:, None]
        W = torch.where(acc2, W_new, W)
        F = torch.where(accept, F_new, F)
        G = torch.where(acc2, G_new, G)
        Dm = torch.where(acc2, Dm_new, Dm)
        if kind == "head_block":
            M = M._replace(
                chol=torch.where(accept[:, None, None], M_new.chol, M.chol),
                diag=torch.where(acc2, M_new.diag, M.diag))
        elif kind == "jacobi":
            M = torch.where(acc2, M_new, M)
        gnorm = torch.where(accept, _norm_lm(G_new), gnorm)
        it = it + accept.to(torch.int32)

        done = accept & (gnorm <= eps * gnorm1)
        done = done | (F < -1.0e32)
        done = done | ((torch.abs(actred) <= 0) & (prered <= 0))
        done = done | ((torch.abs(actred) <= stall_rtol * torch.abs(F))
                       & (torch.abs(prered) <= stall_rtol * torch.abs(F)))
        active = active & ~(done & active)
        trips += 1
        cg_trips += cg_it
    return MultiTronResult(w=W.T, f=F, gnorm=gnorm, iterations=it - 1,
                           converged=gnorm <= eps * gnorm1,
                           newton_trips=trips, cg_trips=cg_trips)
