"""The plain reference: consensus ADMM over the benchmark's data, in plain
PyTorch, float64 by default, every sum in one fixed order (the same bits
every run: a gather and a row sum, a stable column sort and
`segment_reduce`, dense products).

It implements what a job of the configuration states, from the job's keys
and the data remade from the seed (gpubench/datagen.py), and takes nothing
that the program made:

* the data as the job lays it out: `num.blocks` blocks of equal rows, in
  memory one problem of all blocks, streamed (`streaming.groups` G > 1) G
  problems of consecutive blocks; with `head.size` H the H columns with
  the most nonzeros of a problem (ties to the lower id) are the dense head
  stored in `head.dtype`: those entries are summed per (row, column) and
  rounded to it once, every other entry keeps its float32 value;
* the x-update of every problem: for each lambda the blocks' stacked
  logistic loss plus the prior (rho/2)|x_b - (z - u_b)|^2, solved by
  trust-region Newton (LIBLINEAR's TRON, Tron.java) with Jacobi-
  preconditioned CG and the trust region in the preconditioner's norm,
  warm-started at z, stopped at |g| <= eps |g(0)| with eps the problem's
  strictest block tolerance liblinear.epsilon * min(pos, neg) / rows, or
  at a stall (relative changes under the compute dtype's floor: 1e-5 for
  float32, 1e-12 for float64); the Jacobi diagonal is (X o X)'D + rho,
  each nonzero squared as it is stored (a head entry squared in the head's
  dtype, a repeated tail column squared entry by entry);
* features absent from a block solve to their prior mean; the consensus
  z = N rho / (lambda + N rho) (xbar + ubar), the intercept unshrunk; the
  dual update u_b += x_b - z; liblinear.epsilon divided by 10 after an
  iteration whose smallest max|dz| is below 1e-3; the stop at max|dz| <
  epsilon once the inner tolerance is at most 1e-5 (ml-ease's
  RegressionAdmmTrain).

`precision="tf32"` is the control: the same algorithm in float32 with
every data product's operands rounded to TensorFloat-32 (10 mantissa
bits) and summed in float32, as a TF32 tensor core does.

Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from gpubench.datagen import DataSpec, blocks as data_blocks

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


@dataclass
class Job:
    """The job keys the reference reads."""

    lambdas: list
    num_iters: int
    epsilon: float
    liblinear_epsilon: float
    head_size: int
    head_dtype: torch.dtype | None
    compute_dtype: torch.dtype
    groups: int
    max_newton_iter: int = 1000
    max_cg_iter: int = 500
    inner_eps_floor: float = 1e-5

    @classmethod
    def from_keys(cls, job: dict) -> "Job":
        def get(k, d=None):
            return job.get(k, d)
        # the job keys of the one solve the reference implements, at the
        # values it implements them with
        fixed = {"regularizer": 2.0, "multi.rhs": "true",
                 "flat.blocks": "true", "pcg": ("true", "jacobi"),
                 "dual.layout": "false", "relaxation": 1.0,
                 "penalize.intercept": "false",
                 "initialize.boost.rate": 0.0, "rho.adapt.coefficient": 0.0}
        for k, ok in fixed.items():
            if k not in job:
                continue
            v = str(job[k]).strip().lower()
            good = (float(v) == ok if isinstance(ok, float)
                    else v in (ok if isinstance(ok, tuple) else (ok,)))
            if not good:
                raise NotImplementedError(f"the reference runs {k} = {ok}")
        hd = get("head.dtype", "")
        return cls(
            lambdas=[float(v) for v in str(get("lambda")).split(",")],
            num_iters=int(get("num.iters", 10)),
            epsilon=float(get("epsilon", 1e-4)),
            liblinear_epsilon=float(get("liblinear.epsilon", 0.01)),
            head_size=int(get("head.size", 0)),
            head_dtype=DTYPES[hd] if hd else None,
            compute_dtype=DTYPES[get("dtype", "float32")],
            groups=max(int(get("streaming.groups", 0) or 0), 1))

    def rho(self, lam: float) -> float:
        """ml-ease's default rho."""
        return 1.0 if lam <= 100 else 10.0


@dataclass
class Problem:
    """One solve's data: B blocks of R rows over n columns each, stacked
    block-diagonally (the solve's coefficients are B n)."""

    head: torch.Tensor | None   # (B, R, H) the head, in the working dtype
    head_cols: torch.Tensor     # (H,) its columns
    tail_cols: torch.Tensor     # (B, R, K) ELL columns, 0 where no entry
    tail_vals: torch.Tensor     # (B, R, K) ELL values, 0 off the tail
    sort_rows: torch.Tensor     # (T,) b R + row of the column-sorted tail
    sort_vals: torch.Tensor     # (T,) its values
    col_counts: torch.Tensor    # (B n,) entries of each stacked column
    y: torch.Tensor             # (B R,)
    present: torch.Tensor       # (B, n) bool
    eps_scale: list             # per block
    blocks: list
    fingerprints: list          # per block, datagen.fingerprint


@dataclass
class Result:
    z: torch.Tensor                               # (L, n) float64, host
    trips: list = field(default_factory=list)     # per iteration, per problem
    iterations: int = 0
    fingerprints: dict = field(default_factory=dict)   # block -> print


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return tf32(t) if self.name == "tf32" else t


def group_blocks(nblocks: int, groups: int) -> list[list[int]]:
    """Consecutive block ranges, as the streaming split lays them out."""
    g = max(1, min(groups, nblocks))
    bounds = np.linspace(0, nblocks, g + 1).astype(int)
    return [list(range(lo, hi)) for lo, hi in zip(bounds[:-1], bounds[1:])
            if hi > lo]


def head_columns(idx: torch.Tensor, val: torch.Tensor, n: int,
                 H: int) -> torch.Tensor:
    """The H columns with the most nonzero entries, ties to the lower
    id."""
    counts = torch.bincount(idx[val != 0].long(), minlength=n)
    order = torch.sort(-counts, stable=True).indices
    return order[:min(H, n)]


def build_problem(spec: DataSpec, seed: int, which: list, job: Job,
                  prec: Precision, device) -> Problem:
    n, R = spec.dim, spec.rows_per_block
    made = list(data_blocks(spec, seed, device, which))
    prints = [fingerprint(m[1], m[2], m[3]) for m in made]
    idx = torch.stack([m[1] for m in made]).long()     # (B, R, K)
    val = torch.stack([m[2] for m in made])
    y = torch.stack([m[3] for m in made])
    del made
    B, _, K = idx.shape
    present = torch.zeros((B, n), dtype=torch.bool, device=device)
    for b in range(B):
        present[b, idx[b][val[b] != 0]] = True
        present[b, n - 1] = True
    pos = (y == 1).sum(1).double()
    eps_scale = (torch.minimum(pos, R - pos) / R).tolist()
    is_head = torch.zeros_like(val, dtype=torch.bool)
    head = head_cols = None
    if job.head_size > 0:
        head_cols = head_columns(idx, val, n, job.head_size)
        slot = torch.full((n,), -1, dtype=torch.int64, device=device)
        slot[head_cols] = torch.arange(len(head_cols), device=device)
        is_head = (slot[idx] >= 0) & (val != 0)
        # the head's entries summed per (row, column) in float32, slot by
        # slot in row order, then stored in the head's dtype
        H = len(head_cols)
        dense = torch.zeros(B * R * H, dtype=torch.float32, device=device)
        row = torch.arange(B * R, device=device).view(B, R) * H
        for k in range(K):
            m = is_head[..., k]
            dense.index_put_(((row + slot[idx[..., k]].clamp(min=0))[m],),
                             val[..., k][m], accumulate=True)
        hd = job.head_dtype or job.compute_dtype
        head = prec.operand(dense.to(hd).view(B, R, H))
        del dense, row
    tail = (~is_head) & (val != 0)
    tail_vals = prec.operand(torch.where(tail, val, 0.0))
    tail_cols = torch.where(tail, idx, 0)
    # the tail sorted by stacked column (b n + column), rows in order
    key = (idx + torch.arange(B, device=device).view(B, 1, 1) * n)[tail]
    rows = (torch.arange(B * R, device=device).view(B, R, 1)
            .expand(B, R, K))[tail]
    order = torch.sort(key, stable=True).indices
    return Problem(head=head, head_cols=head_cols, tail_cols=tail_cols,
                   tail_vals=tail_vals, sort_rows=rows[order],
                   sort_vals=prec.operand(val[tail][order]),
                   col_counts=torch.bincount(key, minlength=B * n),
                   y=y.reshape(-1).to(prec.dtype), present=present,
                   eps_scale=eps_scale, blocks=list(which),
                   fingerprints=prints)


def fingerprint(idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor):
    """Exact sums of a block's ids, value bits and labels: equal for
    equal arrays."""
    return (int(idx.long().sum()), int(val.view(torch.int32).long().sum()),
            int(y.sum()))


class Tron:
    """TRON with Jacobi-preconditioned CG over L lanes of one problem: W
    (L, N) for N = B n coefficients."""

    def __init__(self, prob: Problem, prec: Precision, stall_rtol: float,
                 max_iter: int, max_cg_iter: int, head_dtype):
        self.p, self.prec, self.head_dtype = prob, prec, head_dtype
        self.stall = stall_rtol
        self.max_iter, self.max_cg_iter = max_iter, max_cg_iter

    def xv(self, V):                    # (L, B n) -> (L, B R)
        p, L = self.p, V.shape[0]
        B, R, _ = p.tail_cols.shape
        Vb = self.prec.operand(V).view(L, B, -1)
        out = torch.stack([(p.tail_vals[b] * Vb[:, b][:, p.tail_cols[b]])
                           .sum(-1) for b in range(B)], 1)   # (L, B, R)
        if p.head is not None:
            for b in range(B):
                out[:, b] += Vb[:, b][:, p.head_cols] @ p.head[b].T
        return out.reshape(L, -1)

    def xtv(self, D, sq=False):         # (L, B R) -> (L, B n)
        """X'D (sq: (X o X)'D, each stored entry squared) summed in a fixed
        order: the tail by stacked column, the head as B products."""
        p, L = self.p, D.shape[0]
        B = p.tail_cols.shape[0]
        D = self.prec.operand(D)
        w = p.sort_vals * p.sort_vals if sq else p.sort_vals
        out = torch.segment_reduce(w[:, None] * D.T[p.sort_rows], "sum",
                                   lengths=p.col_counts, axis=0,
                                   unsafe=True, initial=0.0).T
        if p.head is not None:
            Db = D.view(L, B, -1)
            ob = out.reshape(L, B, -1)
            for b in range(B):
                h = p.head[b]
                if sq:
                    hd = self.head_dtype
                    h = self.prec.operand((h.to(hd) * h.to(hd)).to(h.dtype))
                ob[:, b, p.head_cols] += Db[:, b] @ h
            out = ob.reshape(L, -1)
        return out.contiguous()

    def fgc(self, W, prior, rho):
        y = self.p.y
        yz = y * self.xv(W)
        dw = W - prior
        F = torch.logaddexp(torch.zeros((), dtype=yz.dtype,
                                        device=yz.device), -yz).sum(1) \
            + 0.5 * (dw * dw * rho).sum(1)
        s = torch.sigmoid(yz)
        G = self.xtv((s - 1.0) * y) + dw * rho
        Dm = s * (1.0 - s)
        Hd = self.xtv(Dm, sq=True) + rho
        return F, G, Dm, torch.clamp(Hd, min=1e-12)

    def hv(self, Dm, d, rho):
        return self.xtv(Dm * self.xv(d)) + d * rho

    def solve(self, W, prior, rho, eps):
        """W0 (L, N), prior (L, N), rho (L, 1), eps the tolerance;
        -> (W, newton trips, cg trips)."""
        def dot(a, b):
            return (a * b).sum(1)

        L = W.shape[0]
        y = self.p.y
        g0 = self.xtv(-0.5 * y.expand(L, -1)) - prior * rho
        gnorm1 = torch.sqrt(dot(g0, g0))
        F, G, Dm, M = self.fgc(W, prior, rho)
        delta = torch.sqrt(dot(G, G / M))
        gnorm = torch.sqrt(dot(G, G))
        it = torch.ones(L, dtype=torch.int64, device=W.device)
        active = gnorm > eps * gnorm1
        newton = cgs = 0
        while bool((active & (it <= self.max_iter)).any()):
            # one lock-step CG over every lane (lanes already stopped run
            # along, their steps discarded below)
            s = torch.zeros_like(G)
            r = -G
            z = r / M
            d = z
            rz = dot(r, z)
            cgtol = 0.1 * torch.sqrt(rz)
            done = torch.zeros(L, dtype=torch.bool, device=W.device)
            k = 0
            while k < self.max_cg_iter and bool((~done).any()):
                small = torch.sqrt(torch.clamp(dot(r, z), min=0)) <= cgtol
                Hd = self.hv(Dm, d, rho)
                dHd = dot(d, Hd)
                alpha = torch.where(dHd > 0, rz / torch.where(
                    dHd > 0, dHd, torch.ones_like(dHd)), 0.0)
                s_try = s + alpha[:, None] * d
                boundary = torch.sqrt(dot(s_try * M, s_try)) > delta
                std, sts, dtd = dot(s * M, d), dot(s * M, s), dot(d * M, d)
                dsq = delta * delta
                rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts),
                                             min=0))
                den = std + rad
                alpha_b = torch.where(
                    std >= 0,
                    torch.where(den != 0, (dsq - sts) / torch.where(
                        den != 0, den, torch.ones_like(den)), 0.0),
                    torch.where(dtd != 0, (rad - std) / torch.where(
                        dtd != 0, dtd, torch.ones_like(dtd)), 0.0))
                r_int = r - alpha[:, None] * Hd
                z_int = r_int / M
                rz_new = dot(r_int, z_int)
                beta = torch.where(rz > 0, rz_new / torch.where(
                    rz > 0, rz, torch.ones_like(rz)), 0.0)
                step = ~small & ~done
                bnd = (step & boundary)[:, None]
                inn = (step & ~boundary)[:, None]
                s = torch.where(bnd, s + alpha_b[:, None] * d,
                                torch.where(inn, s_try, s))
                r = torch.where(bnd, r - alpha_b[:, None] * Hd,
                                torch.where(inn, r_int, r))
                d = torch.where(inn, z_int + beta[:, None] * d, d)
                z = torch.where(inn, z_int, z)
                rz = torch.where(inn[:, 0], rz_new, rz)
                done = done | small | bnd[:, 0]
                k += 1
            cgs += k
            newton += 1
            # the step, the trust region and the accept test
            snorm = torch.sqrt(torch.clamp(dot(s * M, s), min=0))
            W_new = W + s
            gs = dot(G, s)
            prered = -0.5 * (gs - dot(s, r))
            F_new, G_new, Dm_new, M_new = self.fgc(W_new, prior, rho)
            actred = F - F_new
            delta = torch.where(it == 1, torch.minimum(delta, snorm), delta)
            den = F_new - F - gs
            a = torch.where(den <= 0, torch.full_like(den, SIGMA3),
                            torch.clamp(-0.5 * gs / torch.where(
                                den <= 0, torch.ones_like(den), den),
                                min=SIGMA1))
            asn = a * snorm
            delta_new = torch.where(
                actred < ETA0 * prered,
                torch.minimum(torch.clamp(a, min=SIGMA1) * snorm,
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
            a2 = accept[:, None]
            W = torch.where(a2, W_new, W)
            F = torch.where(accept, F_new, F)
            G = torch.where(a2, G_new, G)
            Dm = torch.where(a2, Dm_new, Dm)
            M = torch.where(a2, M_new, M)
            gnorm = torch.where(accept, torch.sqrt(dot(G_new, G_new)), gnorm)
            it = it + accept.long()
            stop = (accept & (gnorm <= eps * gnorm1)) | (F < -1.0e32) \
                | ((actred.abs() <= 0) & (prered <= 0)) \
                | ((actred.abs() <= self.stall * F.abs())
                   & (prered.abs() <= self.stall * F.abs()))
            active = active & ~stop
        return W, newton, cgs


def run(spec: DataSpec, seed: int, job: Job, device,
        precision: str = "float64", log=None) -> Result:
    """The job's whole lambda path from z = 0; Result.z the final
    consensus (L, n), float64 on the host."""
    prec = Precision(precision)
    dt = prec.dtype
    n, L = spec.dim, len(job.lambdas)
    probs = [build_problem(spec, seed, which, job, prec, device)
             for which in group_blocks(spec.blocks, job.groups)]
    N = spec.blocks
    out = Result(z=None, fingerprints={
        b: f for p in probs for b, f in zip(p.blocks, p.fingerprints)})
    lam = torch.tensor(job.lambdas, dtype=dt, device=device)[:, None]
    rho = torch.tensor([job.rho(v) for v in job.lambdas], dtype=dt,
                       device=device)[:, None]
    stall = 1e-12 if job.compute_dtype == torch.float64 else 1e-5
    z = torch.zeros((L, n), dtype=dt, device=device)
    us = [torch.zeros((L, len(p.blocks), n), dtype=dt, device=device)
          for p in probs]
    inner_eps, mindiff = job.liblinear_epsilon, 99999999.0
    for iteration in range(1, job.num_iters + 1):
        if iteration > 1 and mindiff < 0.001:
            inner_eps /= 10.0
        xs, trips = [], []
        for p, u in zip(probs, us):
            B = len(p.blocks)
            prior = (z[:, None, :] - u)                       # (L, B, n)
            eps = min(inner_eps * s for s in p.eps_scale)
            tron = Tron(p, prec, stall, job.max_newton_iter,
                        job.max_cg_iter, job.head_dtype or job.compute_dtype)
            W, nt, cg = tron.solve(
                z.repeat(1, B), prior.reshape(L, -1), rho, eps)
            x = torch.where(p.present[None], W.view(L, B, n), prior)
            xs.append(x)
            trips.append((nt, cg))
        xsum = sum(x.sum(1) for x in xs)
        usum = sum(u.sum(1) for u in us)
        v = xsum / N + usum / N
        z_new = (N * rho) / (lam + N * rho) * v
        z_new[:, n - 1] = v[:, n - 1]
        for x, u in zip(xs, us):
            u += x - z_new[:, None, :]
        diffs = (z_new - z).abs().amax(1)
        z = z_new
        mindiff, maxdiff = float(diffs.min()), float(diffs.max())
        out.trips.append(trips)
        out.iterations = iteration
        if log is not None:
            log(f"reference iter {iteration}: inner_eps={inner_eps:g} "
                f"maxdiff={maxdiff!r} trips={trips}")
        if maxdiff < job.epsilon and inner_eps <= job.inner_eps_floor:
            break
    out.z = z.double().cpu()
    return out
