"""Objective helpers of the port.

Only the class-balance tolerance factor lives here for now; the single-
problem objective (LRProblem, fun, hv, ...) of mlease_tpu/ops/objective.py
arrives with the naive and per-item trainers.
"""

from __future__ import annotations

import numpy as np


def class_balance_eps_scale(y: np.ndarray, nrows) -> np.ndarray:
    """eps_effective = eps * min(pos, neg) / l, per problem (reference:
    LibLinear.java:272-276,309-313). `y` is (..., R) padded labels and `nrows`
    the per-problem real row count; padding rows (index >= nrows) are excluded.
    Returns the min(pos,neg)/l factor (1.0 when a block is empty).
    """
    y = np.asarray(y)
    nrows = np.asarray(nrows)
    R = y.shape[-1]
    mask = np.arange(R) < nrows[..., None]
    pos = np.sum((y == 1) & mask, axis=-1)
    l = np.maximum(np.sum(mask, axis=-1), 1)
    neg = np.sum(mask, axis=-1) - pos
    scale = np.minimum(pos, neg) / l
    return np.where(np.sum(mask, axis=-1) > 0, scale, 1.0)
