"""Feature-sharded consensus ADMM: 2-D (block x feat) mesh model parallelism.

Port of mlease_tpu/train/feature_sharded.py. Every reference solve holds
the full coefficient vector in one reducer heap
(reference: src/main/java/com/linkedin/mlease/regression/liblinearfunc/LibLinear.java:340-420),
so n is bounded by one JVM, and by one card in the plain trainer (z is
replicated per rank). Here the coefficient axis is sharded over the mesh's
`feat` dimension, one process per rank:

  * rank (b, s) holds feature shard s (core/feature_shard.py, round-robin,
    shard-local ids) of the blocks of block row b, and the (L, n_local)
    slices of z, u, lambda and the intercept mask;
  * the x-update is the per-block tron_multi(blocks=B_local,
    group=feat group), in consecutive sub-stacks where the stacked ids of
    the B_local blocks would pass int32 (ops/tron_multi.py::SubStacks,
    every shard of a block row cutting the same ranges): one all_reduce
    over `feat` per Xv assembles full
    score rows, every dot and norm is all_reduced, so the (L, B) trust-
    region scalars are the same bits on every shard and the lock-step
    loops take the same trips; X'v, the Jacobi diagonal and the z-update
    are column-local;
  * the consensus is one all_reduce over `block` per iteration (the
    meanModel reduce, RegressionAdmmTrain.java:362-364); the diffs take the
    maximum over `feat`. z is gathered over `feat` only for the sample
    loglik and the result.

The ELL layout only (shard_features refuses a dense head, as in the JAX
package), so neither hand-written kernel runs here. Ranks past the mesh's
block x feat sit out the solve and receive the result by broadcast.
"""

from __future__ import annotations

import logging
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import BlockedData, pack_rows
from mlease_tpu_torch.core.feature_shard import (shard_feature_vector,
                                                 shard_features,
                                                 unshard_feature_vector,
                                                 with_intercept)
from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math
from mlease_tpu_torch.ops.objective import class_balance_eps_scale
from mlease_tpu_torch.ops.tron_multi import (join_block_results,
                                             stack_substacks, substacks_of,
                                             tron_multi, with_prior)
from mlease_tpu_torch.collectives import (all_gather, all_reduce,
                                          broadcast_object)
from mlease_tpu_torch.parallel.mesh import (BLOCK_AXIS, FEAT_AXIS,
                                            mesh_device, pad_blocks)
from mlease_tpu_torch.train.admm import (MAX_NTEST_EVENTS, AdmmConfig,
                                         AdmmResult, _lambda_key,
                                         sample_loglik_lanes)

logger = logging.getLogger(__name__)


class FeatureShardedAdmmTrainer:
    """AdmmTrainer semantics on a 2-D (block, feat) mesh
    (parallel/mesh.py::make_mesh_2d); every rank of the process group
    builds it from the whole host data and calls run(). Config knobs follow
    AdmmConfig; the hybrid dense head and the dual layout are single-card
    layouts and are ignored (the ELL shard is the distributed layout)."""

    def __init__(self, data: BlockedData, vocab, config: AdmmConfig,
                 test_rows: Sequence[Mapping] | None = None, *, mesh):
        if tuple(mesh.mesh_dim_names) != (BLOCK_AXIS, FEAT_AXIS):
            raise ValueError(
                f"mesh axes must be ({BLOCK_AXIS!r}, {FEAT_AXIS!r}); "
                f"got {mesh.mesh_dim_names}")
        if config.regularizer not in (1, 2):
            raise ValueError("Only L1 and L2 regularization supported!")
        self.vocab = vocab
        self.config = config
        self.mesh = mesh
        self.nblocks = data.nblocks
        self.dim = data.dim
        self.lambdas = [float(l) for l in config.lambdas]
        self.rhos = config.resolved_rhos()
        self.device = dev = resolve_device(mesh_device(mesh))
        self.in_mesh = mesh.get_coordinate() is not None
        self.test_arrays = None
        if not self.in_mesh:
            return
        dtype = config.dtype
        db, df = (int(s) for s in mesh.shape)
        b, s = (int(c) for c in mesh.get_coordinate())
        self._block_group = mesh.get_group(BLOCK_AXIS)
        self._feat_group = mesh.get_group(FEAT_AXIS)

        data, valid = pad_blocks(data, db)
        fs = with_intercept(shard_features(data, df), vocab.intercept_index)
        self.fs = fs
        S, nl = fs.n_shards, fs.n_local
        per = fs.nblocks // db
        lo, hi = b * per, (b + 1) * per

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        y = t(fs.y[lo:hi], dtype)
        weight = t(fs.weight[lo:hi], dtype)
        if config.positive_weight != 1.0:
            weight = torch.where(y == 1, config.positive_weight * weight,
                                 weight)
        L = len(self.lambdas)
        # one stacked problem while per*nl and per*R fit int32, else
        # consecutive sub-stacks (a SubStacks), solved in turn
        self.prob = stack_substacks(
            t(fs.indices[s, lo:hi]), t(fs.values[s, lo:hi], dtype), y,
            weight, t(fs.offset[lo:hi], dtype), (None,) * 8,
            torch.zeros((L, per, nl), dtype=dtype, device=dev),
            torch.ones(L, dtype=dtype, device=dev))
        self.present = t(fs.present[s, lo:hi])
        self.block_valid = t(valid[lo:hi] > 0)
        self.eps_scale = t(class_balance_eps_scale(fs.y[lo:hi],
                                                   fs.nrows[lo:hi]), dtype)

        lam = np.stack([
            admm_math.per_feature_lambda(l, self.dim, config.lambda_map,
                                         vocab, dtype=np.float64)
            for l in self.lambdas])                     # (L, n)
        self.lam = t(shard_feature_vector(lam, S, nl,
                                          fill=lam.flat[0])[s], dtype)
        icpt_mask = np.zeros((S, nl), bool)
        if (vocab.intercept_index is not None
                and not config.penalize_intercept):
            icpt_mask[fs.intercept_shard, fs.intercept_local] = True
        self.icpt_mask = t(icpt_mask[s])
        self._shard = s

        if test_rows:
            blk = pack_rows(list(test_rows)[:MAX_NTEST_EVENTS], vocab)
            self.test_arrays = (t(blk.indices), t(blk.values, dtype),
                                t(blk.y, dtype), t(blk.weight, dtype),
                                t(blk.offset, dtype))

    # ------------------------------------------------------------------
    def step(self, z, u, rho_eff, rho_base, eps):
        """One iteration on this rank's (L, n_local) z and (L, B_local,
        n_local) u: the feature-sharded per-block solve, the block
        all_reduce, the masked z-update, the dual update. Returns (z_new,
        u_new, diffs (L,) maxed over the feat group, (newton, cg) trip
        maxima over every block)."""
        cfg = self.config
        L, nl = z.shape
        B = u.shape[1]
        prior_mean = z[:, None, :] - u                       # (L, B, nl)
        r = join_block_results(
            tron_multi(with_prior(p, prior_mean[:, b0:b1], rho_eff),
                       z.T.repeat(b1 - b0, 1), eps[b0:b1],
                       max_iter=cfg.max_newton_iter,
                       max_cg_iter=cfg.max_cg_iter, precondition=cfg.pcg,
                       blocks=b1 - b0, group=self._feat_group)
            for p, (b0, b1) in substacks_of(self.prob, B))
        x = r.w.reshape(B, nl, L).permute(2, 0, 1)
        x = torch.where(self.present[None], x, prior_mean)
        if cfg.relaxation != 1.0:
            x = cfg.relaxation * x + (1.0 - cfg.relaxation) * z[:, None, :]
        bv = self.block_valid[None, :, None]
        x = torch.where(bv, x, torch.zeros_like(x))
        # consensus: ONE all_reduce over the block group per iteration
        sums = all_reduce(torch.stack([x.sum(1), u.sum(1)]), "sum",
                          self._block_group)
        v = sums[0] / self.nblocks + sums[1] / self.nblocks
        rho = rho_base[:, None]
        if cfg.regularizer == 2:
            z_new = admm_math.z_update_l2_masked(
                v, self.lam, rho, self.nblocks, self.icpt_mask)
        else:
            z_new = admm_math.z_update_l1_masked(
                v, self.lam, rho, self.nblocks, self.icpt_mask,
                reference_compat=cfg.reference_l1_compat)
        u_new = torch.where(bv, admm_math.u_update(u, x, z_new[:, None, :]),
                            torch.zeros_like(u))
        diffs = all_reduce(admm_math.max_abs_diff(z_new, z, axis=-1), "max",
                           self._feat_group)
        trips = torch.as_tensor(r.block_trips.max(0), dtype=torch.int64,
                                device=z.device)
        all_reduce(trips, "max", self._block_group)
        return z_new, u_new, diffs, trips.cpu().numpy()

    def _gather_z(self, z: torch.Tensor) -> np.ndarray:
        """(L, n_local) on each shard -> the (L, n) model (host, float64)."""
        z_fs = all_gather(z[None], self._feat_group, dim=0)  # (S, L, nl)
        return unshard_feature_vector(
            z_fs.to(torch.float64).cpu().numpy(), self.dim)

    def sample_loglik(self, z: torch.Tensor,
                      z_host: np.ndarray | None = None) -> np.ndarray:
        """(L,) test logliks of this rank's (L, n_local) shard z, gathered
        over the feature shards (a collective: every rank of the shard's
        group calls it); z_host, a pre-gathered (L, n) copy, saves that
        gather."""
        if z_host is None:
            z_host = self._gather_z(z)
        z_full = torch.as_tensor(z_host, dtype=self.config.dtype,
                                 device=self.device)
        return sample_loglik_lanes(*self.test_arrays, z_full).to(
            torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    def run(self, z0: np.ndarray | None = None) -> AdmmResult:
        """Host driver loop, the schedules and stop rule of AdmmTrainer.run
        (RegressionAdmmTrain.java:281-497); every rank returns the same
        result."""
        result = self._run(z0) if self.in_mesh else None
        if self.mesh.mesh.numel() < torch.distributed.get_world_size():
            # the ranks past the mesh take the result of global rank 0
            # (which is in every mesh)
            result = broadcast_object(result, src=0)
        return result

    def _run(self, z0) -> AdmmResult:
        cfg = self.config
        fs = self.fs
        L, S, nl = len(self.lambdas), fs.n_shards, fs.n_local
        dtype, dev = cfg.dtype, self.device
        B = self.present.shape[0]

        z_full = (np.zeros((L, self.dim)) if z0 is None
                  else np.broadcast_to(z0, (L, self.dim)))
        z = torch.as_tensor(shard_feature_vector(
            np.asarray(z_full, np.float64), S, nl)[self._shard],
            dtype=dtype, device=dev)
        u = torch.zeros((L, B, nl), dtype=dtype, device=dev)
        rho_base = torch.as_tensor(self.rhos, dtype=dtype, device=dev)

        inner_eps = cfg.liblinear_epsilon
        mindiff = 99999999.0
        best_loglik = -9999999.0
        best_model = None
        best_lambda = None
        loglik_history: list[dict] = []
        diff_history: list[dict[str, float]] = []
        iter_times: list[float] = []
        solver_stats: list[dict] = []
        converged = False
        track_ll = self.test_arrays is not None and cfg.test_loglik_per_iter
        t_start = time.monotonic()

        if z0 is not None and track_ll:
            for lam, ll in zip(self.lambdas, self.sample_loglik(z)):
                loglik_history.append({"lambda": _lambda_key(lam), "iter": 0,
                                       "testLoglik": float(ll)})

        iteration = 0
        for iteration in range(1, cfg.num_iters + 1):
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
            eps = torch.as_tensor(inner_eps, dtype=dtype,
                                  device=dev) * self.eps_scale

            z, u, diffs, trips = self.step(z, u, rho_eff, rho_base, eps)
            diffs_np = diffs.to(torch.float64).cpu().numpy()
            iter_times.append(time.monotonic() - t_iter)
            solver_stats.append({"newton_trips": int(trips[0]),
                                 "cg_trips": int(trips[1])})
            mindiff = float(diffs_np.min())
            maxdiff = float(diffs_np.max())
            diff_history.append({_lambda_key(l): float(d)
                                 for l, d in zip(self.lambdas, diffs_np)})
            logger.info(
                "fs iter %d: inner_eps=%g maxdiff=%g mindiff=%g (%.2fs)",
                iteration, inner_eps, maxdiff, mindiff, iter_times[-1])

            if track_ll:
                z_host = self._gather_z(z)
                lls = self.sample_loglik(z, z_host)
                for li, (lam, ll) in enumerate(zip(self.lambdas, lls)):
                    ll = float(ll)
                    loglik_history.append({"lambda": _lambda_key(lam),
                                           "iter": iteration,
                                           "testLoglik": ll})
                    if ll > best_loglik:
                        best_loglik = ll
                        best_lambda = _lambda_key(lam)
                        best_model = LinearModel.from_dense(z_host[li],
                                                            self.vocab)

            if admm_math.should_stop(maxdiff, inner_eps, cfg.epsilon,
                                     cfg.inner_eps_floor):
                converged = True
                break

        z_np = self._gather_z(z)
        # u over both mesh dimensions: (db * S) ranks' (L, B, nl) slices
        db = int(self.mesh.shape[0])
        u_all = all_gather(u[None], self._feat_group, dim=0)  # (S, L, B, nl)
        u_all = all_gather(u_all[None], self._block_group, dim=0)
        u_fs = u_all.permute(1, 2, 0, 3, 4).reshape(S, L, db * B, nl)
        u_np = unshard_feature_vector(
            u_fs.to(torch.float64).cpu().numpy(), self.dim)[:, :self.nblocks]
        models = {
            _lambda_key(lam): LinearModel.from_dense(z_np[i], self.vocab)
            for i, lam in enumerate(self.lambdas)}
        return AdmmResult(
            models=models, best_model=best_model, best_lambda=best_lambda,
            best_loglik=best_loglik, iterations=iteration,
            sample_loglik_history=loglik_history, diff_history=diff_history,
            iter_times=iter_times, solver_stats=solver_stats,
            z=z_np, u=u_np, converged=converged,
            wall_time=time.monotonic() - t_start)
