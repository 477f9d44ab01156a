"""Naive trainer: independent per-(lambda, key) fits + optional model mean.

Port of mlease_tpu/train/naive.py (reference:
src/main/java/com/linkedin/mlease/regression/jobs/RegressionNaiveTrain.java):
the reference fans every record out x nlambdas, shuffles to one reducer per
(lambda, key) and fits an independent liblinear model per reducer. Here the
keys are the blocks of one packed problem and every (lambda, key) model is
a lane of one batched TRON solve; the optional divide-and-average
`compute.model.mean` final model (:134-140,190-198) is a mean over the keys
(core/linear_model.py::mean_model).

Semantics kept from the reference reducer (:286-416):
  * priorVar = 1/lambda by default, per-feature 1/lambda.map[k] overrides
    (:333-339), intercept variance 100000 unless penalize.intercept (:342),
    given to the feature named by intercept.key (default: the bias column)
  * scalar prior.mean for every feature (default 0) (:395 via defaultPriorMean)
  * bias column only when has.intercept (default true) (:361-369)
  * keys with fewer than data.size.threshold rows are skipped (:379-382)
  * output keys "lambda#key" (:228-241); each model carries only the features
    present in its key's data

The solve takes the JAX package's three branches on the same conditions:
the multi-RHS lambda path over the keys folded into one stacked problem
(the default: one joint trust region per lambda, the strictest key's
tolerance), the same stacked data with one trust region per (lambda, key)
(flat_blocks=False, or K*n or K*R past int32: tron_multi(blocks=K), in
consecutive sub-stacks of keys past int32, ops/tron_multi.py::SubStacks),
and the batched reference TRON over (lambda x key) lanes with the data
shared by the lambdas (multi_rhs=False; each key keeps its own int64
ids). The keys are packed as the JAX package packs them, in the ELL layout
alone (no dense head); the sums over the data run with K1, so that they
run in one order every run on the card: the stacked problems carry their
ELL entries as a row-sorted and a column-sorted tail (ops/tron_multi.py::
ell_as_sorted_tails), the lanes problem a column-sorted copy on the card
(ops/objective.py). K2 does not run. Each solve is one program on
the card, as the JAX package jits it (`_solve_keys`): the branches of
train/admm.py::_SolveLoop (CG start, CG trip and Newton epilogue of each
solve or sub-stack) with the naive prior fixed, looped on the card by
ops/device_loop.py, then one host read of the solution and the trips.
Under a mesh (`mesh=`, a 1-D
block mesh of parallel/mesh.py, every rank calling with the whole rows)
the keys are padded to a multiple of the ranks and split over them, each
rank solves its own keys one problem per key (never the joint flat solve,
as in the JAX package), and the solutions are gathered, so every rank
returns the same models.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import pack_blocks
from mlease_tpu_torch.core.linear_model import LinearModel, mean_model
from mlease_tpu_torch.core.vocab import build_vocab
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math
from mlease_tpu_torch.ops.objective import class_balance_eps_scale
from mlease_tpu_torch.ops.tron_multi import (ell_as_sorted_tails,
                                             stack_blocks, stack_fits,
                                             stack_substacks, substacks_of)
from mlease_tpu_torch.collectives import all_gather, all_reduce
from mlease_tpu_torch.parallel.mesh import (BLOCK_AXIS, local_blocks,
                                            mesh_device)
from mlease_tpu_torch.train.admm import (_Solved, _SolveLoop, _graph_pool,
                                         _lambda_key, blocked_problem)


@dataclass
class NaiveConfig:
    """The fields and defaults of mlease_tpu's NaiveConfig, with torch
    dtypes."""

    lambdas: Sequence[float] = (1.0,)
    liblinear_epsilon: float = 0.001  # RegressionNaiveTrain.java:149 default
                                      # (the ADMM warm-start init path sets
                                      # 0.01 explicitly, AdmmTrain.java:246)
    has_intercept: bool = True
    penalize_intercept: bool = False
    prior_mean: float = 0.0
    lambda_map: Mapping[str, float] | None = None
    data_size_threshold: int = 0
    compute_model_mean: bool = False
    positive_weight: float = 1.0
    multi_rhs: bool = True        # lambda path as one solve per data pass
    pcg: bool = True              # Jacobi-preconditioned CG (multi-RHS only)
    flat_blocks: bool = True      # keys folded into one (K*n, L) solve
    dtype: Any = torch.float32
    max_newton_iter: int = 1000
    max_cg_iter: int = 500
    intercept_prior_var: float = 100000.0  # RegressionNaiveTrain.java:342
    intercept_key: str | None = None  # "intercept.key": the feature that
                                      # gets the 1e5 prior variance; None =
                                      # the bias column "(INTERCEPT)"


@dataclass
class NaiveResult:
    models: dict[str, LinearModel]          # "lambda#key" -> model
    mean_models: dict[str, LinearModel] | None  # "lambda" -> mean (final-model)
    skipped_keys: list[str]
    # where a run's time went: host packing, the solve (to the solution's
    # readback; capture_s of it the device loop's warm-up and capture) and
    # its lock-step Newton / CG trips
    solver_stats: dict = field(default_factory=dict)


def _solve_keys(mode: str, probs, L: int, n: int, eps, prior,
                cfg: NaiveConfig) -> _Solved:
    """Every (lambda, key) model as one device loop (train/admm.py::
    _SolveLoop in `mode`, over `probs`, the [(problem, (b0, b1))] of the
    stacked keys or of their sub-stacks, or the lanes problem; eps (K,)
    the keys' tolerances; prior the fixed (prior mean, prior precision),
    each (L, K, n)), from w = 0: x (L, K, n) and the lock-step (Newton,
    CG) trips on the device. On the card the loop is captured and
    launched once; the host reads nothing. The host-driven
    tron_multi / tron (one read a trip) take this seam's place where a
    caller holds the loop to them."""
    t0 = time.monotonic()
    z0 = torch.zeros((L, n), dtype=cfg.dtype, device=eps.device)
    lp = _SolveLoop(mode, probs, L, n, cfg.pcg, cfg.max_newton_iter,
                    cfg.max_cg_iter, z0, None, None, eps, prior=prior)
    lp.own_loop(_graph_pool(eps.device)).prepare()
    capture_s = time.monotonic() - t0
    lp.solve(z0, None, None, eps)
    return _Solved(lp.x(), lp.lockstep_trips(), capture_s, lp)


def train_naive(keyed_rows: Mapping[str, Sequence[Mapping]],
                config: NaiveConfig, vocab=None, mesh=None,
                device: str | torch.device = "cuda") -> NaiveResult:
    """Fit one model per (lambda, key), on the card unless the caller asks
    for device="cpu".

    keyed_rows: {key -> canonical rows}; for block mode keys are "0".."N-1"
    (reference NaiveMapper key selection, RegressionNaiveTrain.java:228-241).
    """
    if mesh is not None:
        device = mesh_device(mesh)
    dev = resolve_device(device)
    cfg = config
    dtype = cfg.dtype
    keys = sorted(keyed_rows)
    kept_keys = [k for k in keys
                 if len(keyed_rows[k]) >= max(cfg.data_size_threshold, 1)]
    skipped = [k for k in keys if k not in kept_keys]
    if not kept_keys:
        return NaiveResult({}, {} if cfg.compute_model_mean else None, skipped)

    if vocab is None:
        vocab = build_vocab((r for k in kept_keys for r in keyed_rows[k]),
                            has_intercept=cfg.has_intercept)
    bias = 1.0 if cfg.has_intercept else 0.0
    t0 = time.monotonic()
    data = pad_data = pack_blocks([keyed_rows[k] for k in kept_keys], vocab,
                                  bias=bias)
    if mesh is not None:      # padded keys solve to the prior, dropped below
        pad_data, _valid = local_blocks(mesh, data)
    lambdas = [float(l) for l in cfg.lambdas]
    K, L, n = pad_data.nblocks, len(lambdas), vocab.size

    # prior variance per (lambda, feature): 1/lambda default, 1/lambda.map[k]
    # overrides, and the unpenalized-intercept variance on the feature that
    # intercept.key names (the bias column by default; a custom name leaves
    # the bias column at 1/lambda, as the reference's variance map does)
    icpt_idx = (vocab.get(cfg.intercept_key) if cfg.intercept_key
                else vocab.intercept_index)
    pvi = np.zeros((L, n))
    for i, lam in enumerate(lambdas):
        pvi[i] = admm_math.per_feature_lambda(lam, n, cfg.lambda_map, vocab)
        if icpt_idx is not None and not cfg.penalize_intercept:
            pvi[i, icpt_idx] = 1.0 / cfg.intercept_prior_var

    def t(a, dt=None):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    y = t(pad_data.y, dtype)
    weight = t(pad_data.weight, dtype)
    if cfg.positive_weight != 1.0:
        weight = torch.where(y == 1, cfg.positive_weight * weight, weight)
    eps = t(cfg.liblinear_epsilon
            * class_balance_eps_scale(pad_data.y, pad_data.nrows),
            dtype)                                                # (K,)
    pvi_t = t(pvi, dtype)                                         # (L, n)
    t1 = time.monotonic()
    arrays = (t(pad_data.indices), t(pad_data.values, dtype), y, weight,
              t(pad_data.offset, dtype), (None,) * 8)
    # the prior: cfg.prior_mean everywhere, pvi per (lambda, feature)
    prior = (torch.full((L, K, n), cfg.prior_mean, dtype=dtype, device=dev),
             pvi_t[:, None, :].expand(L, K, n))
    if cfg.multi_rhs:
        zeros_prior = (torch.zeros((L, K, n), dtype=dtype, device=dev),
                       torch.ones(L, dtype=dtype, device=dev))
        # the keys fold into the coefficient axis (one joint trust region
        # per lambda, the strictest key's tolerance) while the stacked ids
        # fit int32 (the JAX branch's condition, decided before anything
        # is stacked), else one per key, in sub-stacks past int32
        if (cfg.flat_blocks and mesh is None
                and stack_fits(K, n, pad_data.padded_rows)):
            mode = "flat"
            probs = [(stack_blocks(*arrays, *zeros_prior), (0, K))]
        else:
            mode = "per_block"
            probs = substacks_of(stack_substacks(*arrays, *zeros_prior), K)
        # the ELL entries as sorted tails, K1's on the card: one
        # summation order every run
        probs = [(ell_as_sorted_tails(p), r) for p, r in probs]
    else:
        mode = "lanes"
        probs = [(blocked_problem(*arrays, dtype, n), (0, K))]
    solved = _solve_keys(mode, probs, L, n, eps, prior, cfg)
    x, trips = solved.w, solved.trips
    if mesh is not None:      # every rank's keys, the padding dropped
        x = all_gather(x, mesh.get_group(BLOCK_AXIS), dim=1)[:, :data.nblocks]
        trips = all_reduce(trips, "max", mesh.get_group(BLOCK_AXIS))
    # the solve's one host read: the models and the trips
    host = torch.cat([x.reshape(-1).to(torch.float64),
                      trips.to(torch.float64)]).cpu()
    if solved.loop is not None:
        solved.loop.close()
    x = host[:x.numel()].view(x.shape).numpy()
    trips = host[x.size:].long().tolist()
    stats = {"pack_s": t1 - t0, "solve_s": time.monotonic() - t1,
             "newton_trips": trips[0], "cg_trips": trips[1],
             "capture_s": solved.capture_s}

    models: dict[str, LinearModel] = {}
    for i, lam in enumerate(lambdas):
        for b, key in enumerate(kept_keys):
            dense = np.where(data.present[b], x[i, b], 0.0)
            models[f"{_lambda_key(lam)}#{key}"] = LinearModel.from_dense(
                dense, vocab)

    mean_models = None
    if cfg.compute_model_mean:
        mean_models = mean_model(models, nblocks=len(kept_keys),
                                 nlambdas=len(lambdas))
    return NaiveResult(models=models, mean_models=mean_models,
                       skipped_keys=skipped, solver_stats=stats)
