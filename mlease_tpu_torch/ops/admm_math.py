"""Consensus-ADMM algebra: z-update, u-update, schedules — pure functions.

Port of mlease_tpu/ops/admm_math.py to torch tensors; the formulas and their
reference citations are unchanged
(reference: src/main/java/com/linkedin/mlease/regression/jobs/RegressionAdmmTrain.java):

  * L2 z-update  z = kappa * (xbar + ubar), kappa = N*rho / (lambda + N*rho),
    with per-feature kappa for features in lambda.map
    (RegressionAdmmTrain.java:370-404)
  * L1 z-update  soft threshold of (xbar + ubar) at lambda/(rho*N)
    (RegressionAdmmTrain.java:407-437)
  * unpenalized intercept: z_intercept = xbar_i + ubar_i, never shrunk, unless
    penalize.intercept=true (RegressionAdmmTrain.java:392-403,438-449)
  * dual update u <- (u + x) - z (computeU, RegressionAdmmTrain.java:736-765)
  * rho defaults / boost / exponential adaptation
    (RegressionAdmmTrain.java:174-182,310-328)
  * inner-solver epsilon decay schedule (RegressionAdmmTrain.java:338-346)
  * convergence metric max|z - z_last| per lambda (RegressionAdmmTrain.java:456-472)

`rho` may be a Python float or a tensor that broadcasts against the vector
(the trainer passes (L, 1) per-lane values to update all lanes at once).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def default_rho(lam: float) -> float:
    """rho = 1 if lambda <= 100 else 10 (RegressionAdmmTrain.java:174-182)."""
    return 1.0 if lam <= 100 else 10.0


def rho_effective(rho: float, iteration: int, *, initialize_boost_rate: float = 0.0,
                  rho_adapt_coefficient: float = 0.0) -> float:
    """Per-iteration effective rho.

    Iteration 1 with warm-start initialization boosts rho by
    initialize.boost.rate; later iterations decay by
    exp(-(i-1)*rho.adapt.coefficient) when adaptation is on
    (RegressionAdmmTrain.java:310-328, applied to rho in the reducer at :648-658).
    """
    if iteration == 1:
        if initialize_boost_rate > 0:
            return rho * initialize_boost_rate
        return rho
    if rho_adapt_coefficient > 0:
        return rho * math.exp(-(iteration - 1) * rho_adapt_coefficient)
    return rho


def inner_eps_schedule(inner_eps: float, iteration: int, mindiff: float, *,
                       aggressive: bool = False) -> float:
    """liblinear.epsilon decay: start 0.01; /10 when the previous iteration's
    min |dz| < 0.001 (or every iteration > 5 in aggressive mode)
    (RegressionAdmmTrain.java:338-346)."""
    if iteration > 1 and mindiff < 0.001 and not aggressive:
        return inner_eps / 10.0
    if aggressive and iteration > 5:
        return inner_eps / 10.0
    return inner_eps


def per_feature_lambda(lam: float, dim: int, lambda_map: dict[str, float] | None,
                       vocab=None, dtype=np.float64) -> np.ndarray:
    """Dense per-feature lambda vector: default `lam` everywhere, overridden
    by lambda.map entries (the per-feature regularization treatment,
    RegressionAdmmTrain.java:187-198). Host-side numpy, built once."""
    vec = np.full(dim, lam, dtype=dtype)
    if lambda_map:
        if vocab is None:
            raise ValueError("lambda_map requires a vocab")
        for k, v in lambda_map.items():
            idx = vocab.get(k)
            if idx is not None:
                vec[idx] = v
    return vec


def _keep_intercept(z, xbar_plus_ubar, intercept_index, penalize_intercept):
    if intercept_index is not None and not penalize_intercept:
        z = z.clone()
        z[..., intercept_index] = xbar_plus_ubar[..., intercept_index]
    return z


def z_update_l2(xbar_plus_ubar, lam_vec, rho, nblocks: int,
                intercept_index: int | None, penalize_intercept: bool = False):
    """z = kappa * (xbar + ubar), kappa = N*rho/(lambda + N*rho) per feature
    (RegressionAdmmTrain.java:370-404). Shrinkage body shared with the
    masked variant below."""
    z = z_update_l2_masked(xbar_plus_ubar, lam_vec, rho, nblocks, None)
    return _keep_intercept(z, xbar_plus_ubar, intercept_index,
                           penalize_intercept)


def z_update_l1(xbar_plus_ubar, lam_vec, rho, nblocks: int,
                intercept_index: int | None, penalize_intercept: bool = False,
                reference_compat: bool = False):
    """L1 z-update: threshold (xbar + ubar) at t = lambda/(rho*N).

    The textbook consensus-ADMM update (Boyd et al. 2011, cited in the
    reference README.md:42) is the soft-threshold operator, which zeroes the
    band |v| <= t. The reference's implementation
    (RegressionAdmmTrain.java:420-437) shrinks |v| > t toward zero but leaves
    the middle band *unchanged* instead of zeroing it, so it never produces
    exact sparsity. `reference_compat=True` reproduces that behavior bit-for-
    bit; the default performs the correct soft-threshold.
    """
    z = z_update_l1_masked(xbar_plus_ubar, lam_vec, rho, nblocks, None,
                           reference_compat=reference_compat)
    return _keep_intercept(z, xbar_plus_ubar, intercept_index,
                           penalize_intercept)


def z_update_l2_masked(xbar_plus_ubar, lam_vec, rho, nblocks: int,
                       intercept_mask=None):
    """z_update_l2 with the unpenalized intercept selected by a boolean mask
    instead of a scalar index (the feature-sharded form). Equal to
    z_update_l2 when the mask is the intercept one-hot."""
    nrho = nblocks * rho
    z = (nrho / (lam_vec + nrho)) * xbar_plus_ubar
    if intercept_mask is not None:
        z = torch.where(intercept_mask, xbar_plus_ubar, z)
    return z


def z_update_l1_masked(xbar_plus_ubar, lam_vec, rho, nblocks: int,
                       intercept_mask=None, reference_compat: bool = False):
    """Mask-based z_update_l1 (see z_update_l2_masked)."""
    t = lam_vec / (rho * nblocks)
    v = xbar_plus_ubar
    if reference_compat:
        z = torch.where(v > t, v - t, torch.where(v < -t, v + t, v))
    else:
        z = torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)
    if intercept_mask is not None:
        z = torch.where(intercept_mask, v, z)
    return z


def u_update(u, x, z):
    """u <- (u + x) - z (computeU, RegressionAdmmTrain.java:736-765)."""
    return u + x - z


def max_abs_diff(z_new, z_old, axis=None):
    """max |z_new - z_old| — the per-lambda convergence metric
    (LinearModel.maxAbsValue over the difference model,
    RegressionAdmmTrain.java:456-472; includes the intercept coordinate)."""
    d = torch.abs(z_new - z_old)
    return d.max() if axis is None else d.amax(dim=axis)


def should_stop(maxdiff: float, inner_eps: float, epsilon: float = 1e-4,
                inner_eps_floor: float = 1e-5) -> bool:
    """Outer stop: maxdiff < epsilon AND the inner tolerance has decayed to
    <= 1e-5 (RegressionAdmmTrain.java:493-496)."""
    return maxdiff < epsilon and inner_eps <= inner_eps_floor
