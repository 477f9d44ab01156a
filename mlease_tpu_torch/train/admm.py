"""Consensus-ADMM trainer, ported to PyTorch.

Port of mlease_tpu/train/admm.py (reference:
src/main/java/com/linkedin/mlease/regression/jobs/RegressionAdmmTrain.java:129-522)
on its default path: the multi-RHS lambda path (ops/tron_multi.py) over the
B blocks folded into one flat problem, Jacobi-preconditioned CG. One
iteration is the same program as the JAX step: x-update (one TRON solve
serving every lambda lane), presence mask, optional over-relaxation,
consensus means, z-update and dual update; the host driver loop carries the
scalar schedules, sample loglik, best-model tracking and the stop rule.

The flat data problem is stacked once when the trainer is built (the JAX
step restacks it inside its jitted program); each step only sets the prior.

Not ported yet (NotImplementedError, see ROADMAP.md): `run_fused`, the
device mesh, `dual_layout`, the vmapped per-lambda and per-block solvers
(multi_rhs=False, flat_blocks=False) and pcg="head_block", which needs the
per-block step (the solver's head-block preconditioner itself is ported).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import BlockedData, pack_rows, to_hybrid
from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math
from mlease_tpu_torch.ops.objective import class_balance_eps_scale
from mlease_tpu_torch.ops.tron_multi import (MultiProblem, stack_blocks,
                                             tron_multi, with_prior)

logger = logging.getLogger(__name__)

MAX_NTEST_EVENTS = 1_000_000  # RegressionAdmmTrain.java:122


@dataclass
class AdmmConfig:
    """Mirrors the reference's job-file keys (README.md:179-205); the fields
    and defaults of mlease_tpu's AdmmConfig, with torch dtypes."""

    lambdas: Sequence[float] = (1.0,)
    rhos: Sequence[float] | None = None
    num_iters: int = 10
    regularizer: int = 2
    epsilon: float = 1e-4
    liblinear_epsilon: float = 0.01
    aggressive_liblinear_epsilon_decay: bool = False
    penalize_intercept: bool = False
    initialize_boost_rate: float = 0.0
    rho_adapt_coefficient: float = 0.0
    num_click_replicates: int = 1
    test_loglik_per_iter: bool = False
    lambda_map: Mapping[str, float] | None = None
    positive_weight: float = 1.0
    reference_l1_compat: bool = True
    relaxation: float = 1.0
    dual_layout: bool = False     # not ported (raises)
    head_size: int = 0
    multi_rhs: bool = True        # False (vmapped lanes) not ported (raises)
    pcg: Any = True               # True/"jacobi" or False; "head_block" raises
    head_dtype: Any = None        # storage dtype of the dense head
    flat_blocks: bool = True      # False (per-block lock-step) not ported
    dtype: Any = torch.float32
    max_newton_iter: int = 1000
    max_cg_iter: int = 500
    inner_eps_floor: float = 1e-5

    def resolved_rhos(self) -> list[float]:
        if self.rhos is not None:
            if len(self.rhos) != len(self.lambdas):
                raise ValueError(
                    "The number of rho's should be exactly the same as the "
                    "number of lambda's. OR: don't claim rho!")
            return [float(r) for r in self.rhos]
        return [admm_math.default_rho(l) for l in self.lambdas]


@dataclass
class AdmmResult:
    models: dict[str, LinearModel]                 # final z per lambda
    best_model: LinearModel | None
    best_lambda: str | None
    best_loglik: float
    iterations: int
    sample_loglik_history: list[dict]              # [{lambda, iter, testLoglik}]
    diff_history: list[dict[str, float]]
    z: np.ndarray                                  # (L, n) final consensus
    u: np.ndarray                                  # (L, B, n) final duals
    converged: bool
    wall_time: float = 0.0
    iter_times: list[float] = field(default_factory=list)  # seconds/iteration
    solver_stats: list[dict] = field(default_factory=list)  # per-iteration
    # {"newton_trips": int, "cg_trips": int} lock-step loop-trip counts


def _lambda_key(lam: float) -> str:
    """Reference model keys are Java Float.toString of the (float) lambda
    ("1.0", "0.5", "1.0E-4", "1.2345678E7"): plain decimal for
    1e-3 <= |v| < 1e7, computerized scientific notation otherwise, always
    with at least one fractional digit (RegressionAdmmTrain.java:561 keys
    via String.valueOf(float)). Digits are the shortest float32 round-trip
    (Dragon4), matching modern Java; the reference-era FloatingDecimal
    differs only on a handful of pathological subnormals. A copy of
    mlease_tpu's: the keys must be byte-identical."""
    f = np.float32(lam)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    sign = "-" if np.signbit(f) else ""
    if f == 0:
        return sign + "0.0"
    sci = np.format_float_scientific(abs(f), unique=True, trim="0")
    mant, _, exp_s = sci.partition("e")
    e = int(exp_s)
    digits = mant.replace(".", "").rstrip("0") or "0"
    if -3 <= e < 7:
        if e >= 0:
            ipart = digits[:e + 1].ljust(e + 1, "0")
            fpart = digits[e + 1:] or "0"
        else:
            ipart = "0"
            fpart = "0" * (-e - 1) + digits
        return f"{sign}{ipart}.{fpart}"
    fpart = digits[1:] or "0"
    return f"{sign}{digits[0]}.{fpart}E{e}"


def build_admm_step(nblocks: int, regularizer: int, intercept_index: int | None,
                    penalize_intercept: bool, reference_l1_compat: bool,
                    max_newton_iter: int, max_cg_iter: int,
                    relaxation: float = 1.0,
                    dual_layout: bool = False,
                    multi_rhs: bool = False,
                    pcg: Any = False,
                    flat_blocks: bool = False) -> Callable:
    """Build the one-iteration function of the flat multi-RHS path.

    step(prob, present, z, u, lam_vec, rho_eff, rho_base, eps) takes the
    stacked data problem (stack_blocks), present (B, n) bool, z (L, n),
    u (L, B, n), lam_vec (L, n), rho_eff/rho_base (L,) and eps (B,); it
    returns (z_new, u_new, diffs (L,), stats) with stats the lock-step
    "newton_trips"/"cg_trips" counts of the solve."""
    if dual_layout:
        raise NotImplementedError(
            "dual_layout is not ported (ROADMAP.md, ADMM paths still to port)")
    if not (multi_rhs and flat_blocks):
        raise NotImplementedError(
            "only the flat-blocks multi-RHS step is ported (multi_rhs=True, "
            "flat_blocks=True); the vmapped solvers are in ROADMAP.md")
    if regularizer not in (1, 2):
        raise ValueError("Only L1 and L2 regularization supported!")

    def step(prob: MultiProblem, present, z, u, lam_vec, rho_eff, rho_base,
             eps):
        # rho_eff (boost/decay-adapted) shapes only the x-subproblem prior;
        # the consensus z-update uses the base rho
        # (RegressionAdmmTrain.java:368-380, :648-658)
        L, n = z.shape
        B = u.shape[1]
        prior_mean = z[:, None, :] - u                       # (L, B, n)
        res = tron_multi(with_prior(prob, prior_mean, rho_eff),
                         z.T.repeat(B, 1), eps.min(),
                         max_iter=max_newton_iter, max_cg_iter=max_cg_iter,
                         precondition=pcg)
        x = res.w.reshape(B, n, L).permute(2, 0, 1)          # (L, B, n)
        stats = {"newton_trips": res.newton_trips,
                 "cg_trips": res.cg_trips}
        # absent-feature exactness: features with no data in block b solve
        # to the prior mean z - u_b (LibLinear.java:373-397)
        x = torch.where(present[None, :, :], x, prior_mean)
        if relaxation != 1.0:
            x = relaxation * x + (1.0 - relaxation) * z[:, None, :]
        v = x.sum(1) / nblocks + u.sum(1) / nblocks           # xbar + ubar
        rho = rho_base[:, None]
        if regularizer == 2:
            z_new = admm_math.z_update_l2(v, lam_vec, rho, nblocks,
                                          intercept_index, penalize_intercept)
        else:
            z_new = admm_math.z_update_l1(
                v, lam_vec, rho, nblocks, intercept_index, penalize_intercept,
                reference_compat=reference_l1_compat)
        u_new = admm_math.u_update(u, x, z_new[:, None, :])
        diffs = admm_math.max_abs_diff(z_new, z, axis=-1)
        return z_new, u_new, diffs, stats

    return step


def sample_loglik_lanes(indices, values, y, weight, offset,
                        z: torch.Tensor) -> torch.Tensor:
    """Per-lambda mean weighted test loglik of consensus models z (L, n)
    (RegressionAdmmTrain.java:766-811):
    sum_i w_i * -log1p(exp(-+xbeta)) / sum_i w_i."""
    scores = (values[None] * z[:, indices]).sum(-1) + offset[None]
    yz = -y[None] * scores
    ll = -torch.logaddexp(yz.new_zeros(()), yz) * weight[None]
    return ll.sum(1) / weight.sum()


class AdmmTrainer:
    def __init__(self, data: BlockedData, vocab, config: AdmmConfig,
                 test_rows: Sequence[Mapping] | None = None,
                 device: str | torch.device = "cuda"):
        self.device = dev = resolve_device(device)
        self.vocab = vocab
        self.config = config
        self.nblocks = data.nblocks
        dtype = config.dtype
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"compute dtype {dtype} is not ported; the solver and its "
                f"kernel run float32 or float64")
        if config.multi_rhs and config.pcg == "head_block":
            raise NotImplementedError(
                "pcg='head_block' needs the per-block (non-flat) ADMM step, "
                "which is not ported yet (ROADMAP.md item A1); "
                "tron_multi(precondition='head_block') itself is")

        if config.head_size > 0 and data.head is None:
            data = to_hybrid(data, config.head_size)
        self.data = data
        self.dim = data.dim
        self.lambdas = [float(l) for l in config.lambdas]
        self.rhos = config.resolved_rhos()

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        y = t(data.y, dtype)
        weight = t(data.weight, dtype)
        if config.positive_weight != 1.0:
            weight = torch.where(y == 1, config.positive_weight * weight,
                                 weight)
        self.present = t(data.present)
        # per-block class-balance tolerance factors (LibLinear.java:309-313)
        self.eps_scale = t(class_balance_eps_scale(data.y, data.nrows), dtype)

        head = (None,) * 8
        if data.head is not None:
            head_dtype = (config.head_dtype if config.head_dtype is not None
                          else dtype)
            head = (t(data.head, head_dtype), t(data.head_ids),
                    t(data.tail_rows), t(data.tail_cols),
                    t(data.tail_vals, dtype), t(data.tail_c_rows),
                    t(data.tail_c_cols), t(data.tail_c_vals, dtype))
        L = len(self.lambdas)
        self.prob = stack_blocks(
            t(data.indices), t(data.values, dtype), y, weight,
            t(data.offset, dtype), head,
            torch.zeros((L, data.nblocks, self.dim), dtype=dtype, device=dev),
            torch.ones(L, dtype=dtype, device=dev))

        lam_vecs = np.stack([
            admm_math.per_feature_lambda(l, self.dim, config.lambda_map,
                                         vocab, dtype=np.float64)
            for l in self.lambdas])
        self.lam_vec = t(lam_vecs, dtype)

        self.step = build_admm_step(
            nblocks=self.nblocks,
            regularizer=config.regularizer,
            intercept_index=vocab.intercept_index,
            penalize_intercept=config.penalize_intercept,
            reference_l1_compat=config.reference_l1_compat,
            max_newton_iter=config.max_newton_iter,
            max_cg_iter=config.max_cg_iter,
            relaxation=config.relaxation,
            dual_layout=config.dual_layout,
            multi_rhs=config.multi_rhs,
            pcg=config.pcg,
            flat_blocks=config.flat_blocks)

        # sample-test loglik arrays (first MAX_NTEST_EVENTS rows)
        self.test_arrays = None
        if test_rows:
            blk = pack_rows(list(test_rows)[:MAX_NTEST_EVENTS], vocab)
            self.test_arrays = (t(blk.indices), t(blk.values, dtype),
                                t(blk.y, dtype), t(blk.weight, dtype),
                                t(blk.offset, dtype))

    # ------------------------------------------------------------------
    def sample_loglik(self, z: torch.Tensor) -> np.ndarray:
        return sample_loglik_lanes(*self.test_arrays, z).cpu().numpy()

    def run_fused(self, *args, **kwargs):
        raise NotImplementedError(
            "run_fused (the on-device driver loop) is not ported yet; use "
            "run() (ROADMAP.md)")

    # ------------------------------------------------------------------
    def run(self, z0: np.ndarray | None = None,
            u0: np.ndarray | None = None, *, start_iteration: int = 1,
            inner_eps0: float | None = None, mindiff0: float = 99999999.0,
            best_loglik0: float = -9999999.0,
            callback: Callable | None = None) -> AdmmResult:
        """Run the driver loop.

        z0/u0/start_iteration/inner_eps0/mindiff0/best_loglik0 resume from a
        checkpoint (utils/checkpoint, or a JAX run's state through
        mlease_tpu_torch.convert) — the analogue of restarting from the
        reference's iter-i/ HDFS state. The callback receives z and u as
        tensors on the trainer's device."""
        cfg = self.config
        L, n = len(self.lambdas), self.dim
        dtype, dev = cfg.dtype, self.device

        z = (torch.zeros((L, n), dtype=dtype, device=dev) if z0 is None
             else torch.as_tensor(np.broadcast_to(z0, (L, n)).copy(),
                                  dtype=dtype, device=dev))
        u_np = np.zeros((L, self.data.nblocks, n))
        if u0 is not None:
            u_np[:, :u0.shape[1], :] = np.asarray(u0)
        u = torch.as_tensor(u_np, dtype=dtype, device=dev)

        inner_eps = (cfg.liblinear_epsilon if inner_eps0 is None
                     else float(inner_eps0))
        mindiff = mindiff0
        best_loglik = best_loglik0
        best_model: LinearModel | None = None
        best_lambda: str | None = None
        loglik_history: list[dict] = []
        diff_history: list[dict[str, float]] = []
        iter_times: list[float] = []
        solver_stats: list[dict] = []
        converged = False
        track_ll = self.test_arrays is not None and cfg.test_loglik_per_iter
        t_start = time.monotonic()

        # iteration-0 loglik when warm-started (RegressionAdmmTrain.java:277-280)
        if z0 is not None and track_ll:
            for lam, ll in zip(self.lambdas, self.sample_loglik(z)):
                loglik_history.append({"lambda": _lambda_key(lam), "iter": 0,
                                       "testLoglik": float(ll)})

        rho_base = torch.as_tensor(self.rhos, dtype=dtype, device=dev)
        iteration = start_iteration - 1
        for iteration in range(start_iteration, cfg.num_iters + 1):
            t_iter = time.monotonic()
            inner_eps = admm_math.inner_eps_schedule(
                inner_eps, iteration, mindiff,
                aggressive=cfg.aggressive_liblinear_epsilon_decay)
            rho_eff = torch.as_tensor([
                admm_math.rho_effective(
                    r, iteration,
                    initialize_boost_rate=(cfg.initialize_boost_rate
                                           if z0 is not None else 0.0),
                    rho_adapt_coefficient=cfg.rho_adapt_coefficient)
                for r in self.rhos], dtype=dtype, device=dev)
            eps = inner_eps * self.eps_scale

            z, u, diffs, stats = self.step(self.prob, self.present, z, u,
                                           self.lam_vec, rho_eff, rho_base,
                                           eps)
            diffs_np = diffs.to(torch.float64).cpu().numpy()  # host sync
            iter_times.append(time.monotonic() - t_iter)
            solver_stats.append(dict(stats))
            mindiff = float(diffs_np.min())
            maxdiff = float(diffs_np.max())
            diff_history.append({_lambda_key(l): float(d)
                                 for l, d in zip(self.lambdas, diffs_np)})
            logger.info("iter %d: inner_eps=%g maxdiff=%g mindiff=%g (%.2fs)",
                        iteration, inner_eps, maxdiff, mindiff,
                        iter_times[-1])

            iter_logliks = None
            if track_ll:
                iter_logliks = []
                for li, (lam, ll) in enumerate(zip(self.lambdas,
                                                   self.sample_loglik(z))):
                    ll = float(ll)
                    entry = {"lambda": _lambda_key(lam), "iter": iteration,
                             "testLoglik": ll}
                    loglik_history.append(entry)
                    iter_logliks.append(entry)
                    # best-model tracking (RegressionAdmmTrain.java:812-845)
                    if ll > best_loglik:
                        best_loglik = ll
                        best_lambda = _lambda_key(lam)
                        best_model = LinearModel.from_dense(
                            z[li].to(torch.float64).cpu().numpy(), self.vocab)

            if callback is not None:
                callback(iteration=iteration, z=z, u=u, diffs=diffs_np,
                         inner_eps=inner_eps, logliks=iter_logliks)

            if admm_math.should_stop(maxdiff, inner_eps, cfg.epsilon,
                                     cfg.inner_eps_floor):
                converged = True
                break

        z_np = z.to(torch.float64).cpu().numpy()
        models = {
            _lambda_key(lam): LinearModel.from_dense(z_np[i], self.vocab)
            for i, lam in enumerate(self.lambdas)}
        return AdmmResult(
            models=models, best_model=best_model, best_lambda=best_lambda,
            best_loglik=best_loglik, iterations=iteration,
            sample_loglik_history=loglik_history, diff_history=diff_history,
            iter_times=iter_times, solver_stats=solver_stats,
            z=z_np, u=u.to(torch.float64).cpu().numpy()[:, :self.nblocks],
            converged=converged, wall_time=time.monotonic() - t_start)
