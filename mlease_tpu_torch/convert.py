"""Carry state and results of a mlease_tpu (JAX) run into the port.

Both trainers keep the same state: consensus z (L, n), duals u (L, B, n),
the iteration reached, the inner tolerance, the last min |dz| and the best
sample loglik. `state_from_numpy` turns that state, as numpy arrays (the
JAX AdmmResult's z/u, or a checkpoint), into keyword arguments of the port's
`AdmmTrainer.run`, which then continues the JAX run:

    res = trainer.run(**state_from_numpy(jax_res.z, jax_res.u,
                                         iteration=k, inner_eps=eps_k,
                                         mindiff=mindiff_k))

`state_from_checkpoint` does the same for a checkpoint directory written by
either package's utils/checkpoint (iter-NNNNN.npz + .json manifests). The
streaming trainers of both packages keep the same state in the same files,
so the same kwargs resume `StreamingAdmmTrainer.run` from a JAX streaming
run's checkpoint.

`item_models_from_jax` turns the JAX per-item trainer's ItemResult into the
port's, so that JAX-trained item models can be scored or written by the
port (model files written by either package's `write_item_models` read
back in the other as they are).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mlease_tpu_torch.utils import checkpoint as ckpt


def _widened(a) -> np.ndarray:
    """A state array as float64: a bfloat16 state may come as its bits
    (uint16, or the 2-byte void arrays of a JAX bfloat16 checkpoint, which
    numpy reads without ml_dtypes) or as float32; every bfloat16 value is
    exact in either."""
    a = np.asarray(a)
    if ckpt.is_bf16_bits(a):
        a = ckpt.bf16_bits_to_float(a)
    return np.asarray(a, np.float64)


def state_from_numpy(z, u, *, iteration: int = 0,
                     inner_eps: float | None = None,
                     mindiff: float = 99999999.0,
                     best_loglik: float = -9999999.0) -> dict[str, Any]:
    """Resume kwargs for AdmmTrainer.run after `iteration` completed
    iterations of a run whose state is (z (L, n), u (L, B, n)); a bfloat16
    state as its bits or as float32 (see `_widened`)."""
    z = _widened(z)
    u = _widened(u)
    if z.ndim != 2 or u.ndim != 3 or u.shape[0] != z.shape[0] \
            or u.shape[2] != z.shape[1]:
        raise ValueError(f"expected z (L, n) and u (L, B, n); got "
                         f"{z.shape} and {u.shape}")
    return dict(z0=z, u0=u, start_iteration=int(iteration) + 1,
                inner_eps0=inner_eps, mindiff0=float(mindiff),
                best_loglik0=float(best_loglik))


def state_from_checkpoint(ckpt_dir: str) -> dict[str, Any] | None:
    """Resume kwargs from the newest checkpoint in `ckpt_dir` (None when
    the directory holds none)."""
    state = ckpt.load_latest(ckpt_dir)
    if state is None:
        return None
    return state_from_numpy(state["z"], state["u"],
                            iteration=state["iteration"],
                            inner_eps=state["inner_eps"],
                            mindiff=state["mindiff"],
                            best_loglik=state["best_loglik"])


def item_models_from_jax(result):
    """A mlease_tpu.train.item.ItemResult (duck-typed: `models` and
    `posterior_var` map keys to objects with `coefficients` and `intercept`,
    `covariances` maps keys to {(f1, f2): v} or is None) -> the port's
    ItemResult, with plain Python floats."""
    from mlease_tpu_torch.core.linear_model import LinearModel
    from mlease_tpu_torch.train.item import ItemResult

    def model(m):
        return LinearModel({k: float(v) for k, v in m.coefficients.items()},
                           intercept=float(m.intercept))

    covs = None
    if result.covariances is not None:
        covs = {key: {pair: float(v) for pair, v in cov.items()}
                for key, cov in result.covariances.items()}
    return ItemResult(
        models={k: model(m) for k, m in result.models.items()},
        posterior_var={k: model(m) for k, m in result.posterior_var.items()},
        covariances=covs)
