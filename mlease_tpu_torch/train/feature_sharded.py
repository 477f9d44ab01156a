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

`run()` takes each x-update as the JAX step's one jitted program takes
it: through `_x_update`, a device loop of the solve's branches
(train/admm.py::_SolveLoop, one part a sub-stack, per block, the feat
group's all_reduces inside the branches), captured at the first
iteration and kept, freed with the trainer. On the card the loop's
all_reduces are NCCL calls captured into its CUDA graphs; a gloo feat
group of two or more ranks cannot be captured there, and run() raises
ValueError before the loop is made. On the CPU the branches run eagerly
over gloo, every rank taking the same phases (they branch only on
all_reduced values). The block all_reduce of the consensus, the z- and
u-updates, the diffs' maximum over `feat` and the trips' maximum over
`block` stay eager collectives on the stream (a one-rank feat group's
solve makes no collective: nothing to sum), and an iteration reads the
host once (the diffs and the trip maxima in one copy; the sample loglik
makes its own gather). `step()` is the host-driven iteration (tron_multi's
host loops, a read a Newton and a CG trip), the reference the loop is
held to.

The ELL layout only (shard_features refuses a dense head, as in the JAX
package). X'v sums each shard's ELL slots over their column-sorted copy
with K1 (ops/tron_multi.py::with_column_copy), so the solve gives the same
bits every run; K2 does not run. Ranks past the mesh's block x feat sit
out the solve and receive the result by broadcast.
"""

from __future__ import annotations

import logging
import time
import weakref
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
                                         AdmmResult, _close_loops,
                                         _graph_pool, _lambda_key,
                                         _rho_table, _SolveLoop, _to_device,
                                         sample_loglik_lanes, x_prior)

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
        # the solve's group: over one feat shard there is nothing to sum
        # (the JAX psum over a size-1 axis is the identity), so that solve
        # makes no collective and its loop captures none
        self._solve_group = self._feat_group if df > 1 else None

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
        self._loops: dict[str, _SolveLoop] = {}   # freed with the trainer
        weakref.finalize(self, _close_loops, self._loops).atexit = False

        if test_rows:
            blk = pack_rows(list(test_rows)[:MAX_NTEST_EVENTS], vocab)
            self.test_arrays = (t(blk.indices), t(blk.values, dtype),
                                t(blk.y, dtype), t(blk.weight, dtype),
                                t(blk.offset, dtype))

    # ------------------------------------------------------------------
    def step(self, z, u, rho_eff, rho_base, eps):
        """One iteration on this rank's (L, n_local) z and (L, B_local,
        n_local) u, the host-driven reference of run()'s: the
        feature-sharded per-block solve on tron_multi's host loops, the
        block all_reduce, the masked z-update, the dual update. Returns
        (z_new, u_new, diffs (L,) maxed over the feat group, (newton, cg)
        trip maxima over every block, on the host)."""
        x, trips = self._host_x_update(z, u, rho_eff, eps)
        z_new, u_new, diffs = self._consensus(x, z, u, rho_base)
        return z_new, u_new, diffs, self._trip_max(trips).cpu().numpy()

    def _finish(self, x, z, u):
        """The x-update's mask (a feature absent from a block solves to its
        prior mean) and over-relaxation."""
        cfg = self.config
        x = torch.where(self.present[None], x, x_prior(z, u))
        if cfg.relaxation != 1.0:
            x = cfg.relaxation * x + (1.0 - cfg.relaxation) * z[:, None, :]
        return x

    def _host_x_update(self, z, u, rho_eff, eps):
        """The x-update through tron_multi's host loops (a read a Newton
        and a CG trip): (x (L, B_local, n_local), its (B_local, 2) (Newton,
        CG) trips on the device)."""
        cfg = self.config
        L, nl = z.shape
        B = u.shape[1]
        prior_mean = x_prior(z, u)                           # (L, B, nl)
        r = join_block_results(
            tron_multi(with_prior(p, prior_mean[:, b0:b1], rho_eff),
                       z.T.repeat(b1 - b0, 1), eps[b0:b1],
                       max_iter=cfg.max_newton_iter,
                       max_cg_iter=cfg.max_cg_iter, precondition=cfg.pcg,
                       blocks=b1 - b0, group=self._solve_group)
            for p, (b0, b1) in substacks_of(self.prob, B))
        x = r.w.reshape(B, nl, L).permute(2, 0, 1)
        return self._finish(x, z, u), torch.as_tensor(
            r.block_trips, dtype=torch.int64, device=z.device)

    def _x_update(self, z, u, rho_eff, eps):
        """run()'s x-update through the trainer's _SolveLoop (made, and on
        the card captured, at the first iteration, then kept): the same
        result as _host_x_update, bit for bit, without a host read."""
        loop = self._loops.get("x")
        if loop is None:
            self._check_capturable()
            cfg = self.config
            loop = _SolveLoop(
                "per_block", substacks_of(self.prob, u.shape[1]),
                z.shape[0], z.shape[1], cfg.pcg, cfg.max_newton_iter,
                cfg.max_cg_iter, z, u, rho_eff, eps, group=self._solve_group)
            loop.own_loop(_graph_pool(self.device)).prepare()
            self._loops["x"] = loop
        loop.solve(z, u, rho_eff, eps)
        return self._finish(loop.x(), z, u), loop.trips()

    def _check_capturable(self):
        """On the card the loop captures the feat group's all_reduces into
        its CUDA graphs, which only NCCL allows; a one-rank feat group's
        solve makes none. Decided from the backend, before anything is
        captured."""
        group = self._solve_group
        if self.device.type == "cuda" and group is not None:
            backend = torch.distributed.get_backend(group)
            if backend != "nccl":
                raise ValueError(
                    f"FeatureShardedAdmmTrainer.run on a CUDA device "
                    f"captures the feat group's all_reduces into its "
                    f"x-update's CUDA graphs (ROADMAP.md A21), which needs "
                    f"NCCL; this group runs {backend!r} over "
                    f"{torch.distributed.get_world_size(group)} ranks: "
                    f"use step(), the host-driven iteration")

    def _consensus(self, x, z, u, rho_base):
        """The block all_reduce of the x-update's and u's partial sums,
        the masked z-update, the dual update and the diffs maxed over the
        feat group, all on the device: (z_new, u_new, diffs (L,))."""
        cfg = self.config
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
        return z_new, u_new, diffs

    def _trip_max(self, trips):
        """(2,) int64 on the device: the (Newton, CG) maxima over this
        rank's blocks and then over the block group."""
        return all_reduce(trips.amax(0).to(torch.int64), "max",
                          self._block_group)

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
        """The driver loop, the schedules and stop rule of AdmmTrainer.run
        (RegressionAdmmTrain.java:281-497), each x-update on the trainer's
        device loop (`_x_update`), one host read an iteration; every rank
        returns the same result. On a CUDA device a feat group of two or
        more ranks must run NCCL (ValueError otherwise)."""
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
        rho_tab = _rho_table(self.rhos, cfg.num_iters, cfg, z0 is not None,
                             dev)

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
            rho_eff = rho_tab[iteration]
            # the scalar rounded to the compute dtype first, as AdmmTrainer
            eps = _to_device(inner_eps, dtype, dev) * self.eps_scale

            # the span the device idle share of an iteration is read over
            with torch.profiler.record_function("fs_iteration"):
                x, trips = self._x_update(z, u, rho_eff, eps)
                z, u, diffs = self._consensus(x, z, u, rho_base)
                # the iteration's one host sync
                host = torch.cat([diffs.to(torch.float64),
                                  self._trip_max(trips).to(torch.float64)]
                                 ).cpu()
            diffs_np = host[:L].numpy()
            iter_times.append(time.monotonic() - t_iter)
            solver_stats.append({"newton_trips": int(host[L]),
                                 "cg_trips": int(host[L + 1])})
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
