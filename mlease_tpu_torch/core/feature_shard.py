"""Feature (column) sharding for model-parallel consensus solves.

A copy of mlease_tpu/core/feature_shard.py (numpy only), its imports
pointed at the port's core/dataset.py. In the port the shards live on the
ranks of a mesh's "feat" dimension (parallel/mesh.py::make_mesh_2d) and the
solve's all_reduce over them is ops/tron_multi.py's `group`.

The reference caps model size at one reducer's heap: every LibLinear.train
call materializes the full coefficient vector per partition
(reference: src/main/java/com/linkedin/mlease/regression/liblinearfunc/LibLinear.java:340-420),
so n is bounded by a single JVM. The TPU-native answer is feature model
parallelism over a mesh axis: each device holds a column shard of every
block's data (shard-LOCAL column ids) plus the matching slices of
z/u/priors, the scores psum over the feature axis assembles full rows, and
X'v / the z-update stay column-local (see ops/tron_multi.py `axis_name` and
train/feature_sharded.py). Coefficient-state HBM per chip then scales as
n / n_shards.

Columns are dealt round-robin (global id g -> shard g % S, local id g // S):
with a frequency-ordered vocabulary a contiguous split would put every hot
column in shard 0; round-robin balances nonzeros across shards to within one
column of optimal for any frequency profile.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mlease_tpu_torch.core.dataset import BlockedData, _round_up


class FeatureShardedData(NamedTuple):
    """BlockedData split column-wise into S shards (leading shard axis).

    Row-space arrays (y/weight/offset) are NOT duplicated per shard — they
    are replicated over the feature mesh axis at device_put time.
    """

    indices: np.ndarray   # (S, B, R, Kf) int32 shard-LOCAL column ids
    values: np.ndarray    # (S, B, R, Kf) — 0.0 on padding
    present: np.ndarray   # (S, B, n_local) bool
    y: np.ndarray         # (B, R)
    weight: np.ndarray    # (B, R)
    offset: np.ndarray    # (B, R)
    nrows: np.ndarray     # (B,)
    nblocks: int
    dim: int              # original (unpadded) n
    n_shards: int
    n_local: int          # ceil(n / S): padded per-shard width
    intercept_shard: int | None = None
    intercept_local: int | None = None


def shard_feature_vector(v: np.ndarray, n_shards: int, n_local: int,
                         fill=0.0) -> np.ndarray:
    """Per-feature vector (..., n) -> per-shard slices (S, ..., n_local).

    Round-robin layout: out[s, ..., l] = v[..., l * S + s] (fill beyond n).
    """
    n = v.shape[-1]
    pad = n_shards * n_local - n
    if pad:
        v = np.concatenate(
            [v, np.full(v.shape[:-1] + (pad,), fill, v.dtype)], axis=-1)
    # (..., n_local, S) -> S leading
    resh = v.reshape(v.shape[:-1] + (n_local, n_shards))
    return np.moveaxis(resh, -1, 0)


def unshard_feature_vector(v_fs: np.ndarray, dim: int) -> np.ndarray:
    """(S, ..., n_local) -> (..., n): inverse of shard_feature_vector."""
    resh = np.moveaxis(v_fs, 0, -1)          # (..., n_local, S)
    flat = resh.reshape(resh.shape[:-2] + (-1,))
    return flat[..., :dim]


def shard_features(data: BlockedData, n_shards: int, *,
                   nnz_multiple: int = 8) -> FeatureShardedData:
    """Partition a packed dataset's columns into `n_shards` round-robin
    shards with local ids (ELL layout only — the dense-head hybrid keeps the
    whole coefficient slab per device and is the single-chip layout)."""
    if data.head is not None:
        raise ValueError("feature sharding operates on the plain ELL layout")
    S = int(n_shards)
    if S < 1:
        raise ValueError("n_shards must be >= 1")
    n = data.dim
    n_local = (n + S - 1) // S
    B, R, K = data.indices.shape

    shard_of = data.indices % S                       # (B, R, K)
    local_of = data.indices // S
    real = data.values != 0

    # per-(shard, row) nonzero counts set the uniform padded width
    kf = 0
    for s in range(S):
        kf = max(kf, int(((shard_of == s) & real).sum(axis=-1).max()))
    Kf = _round_up(max(kf, 1), nnz_multiple)

    indices_fs = np.zeros((S, B, R, Kf), np.int32)
    values_fs = np.zeros((S, B, R, Kf), data.values.dtype)
    take = min(Kf, K)   # Kf may exceed K after rounding up to nnz_multiple
    for s in range(S):
        sel = (shard_of == s) & real                  # (B, R, K)
        # stable argsort of ~sel packs this shard's entries first per row
        order = np.argsort(~sel, axis=-1, kind="stable")
        idx_p = np.take_along_axis(local_of, order, -1)[..., :take]
        val_p = np.take_along_axis(
            np.where(sel, data.values, 0), order, -1)[..., :take]
        if take < Kf:
            pad = [(0, 0), (0, 0), (0, Kf - take)]
            idx_p = np.pad(idx_p, pad)
            val_p = np.pad(val_p, pad)
        # unselected slots carry value 0 (exact no-ops); clamp their local
        # ids into range for the (harmless) gather
        indices_fs[s] = np.where(val_p != 0, idx_p, 0)
        values_fs[s] = val_p

    present_fs = shard_feature_vector(
        data.present.astype(bool), S, n_local, fill=False)  # (S, B, n_local)

    return FeatureShardedData(
        indices=indices_fs, values=values_fs,
        present=np.ascontiguousarray(present_fs),
        y=data.y, weight=data.weight, offset=data.offset,
        nrows=data.nrows, nblocks=data.nblocks, dim=n,
        n_shards=S, n_local=n_local)


def with_intercept(fs: FeatureShardedData,
                   intercept_index: int | None) -> FeatureShardedData:
    """Record which (shard, local) slot holds the intercept column."""
    if intercept_index is None:
        return fs
    return fs._replace(intercept_shard=int(intercept_index) % fs.n_shards,
                       intercept_local=int(intercept_index) // fs.n_shards)
