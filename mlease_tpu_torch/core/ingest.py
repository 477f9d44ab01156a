"""Columnar ingest: native-decoded CSR rows -> BlockedData.

Port of mlease_tpu/core/ingest.py, logic unchanged (numpy on the host; the
packed blocks go to the card in the trainers).

The scalable ingest path for >memory datasets: rows come out of the C++
decoder (mlease_tpu_torch.io.fast_decode) as flat columnar arrays, the prepare
stage (partition assignment + click replication, reference:
RegressionPrepare.java:95-191) runs vectorized in numpy, and block packing
goes straight from CSR to the padded ELL device layout without materializing
per-row Python objects. Semantics are identical to the record-at-a-time path
in mlease_tpu_torch.core.prepare / dataset (same RNG stream for partition
assignment, same weight scaling, same padding rules).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mlease_tpu_torch.core.dataset import BlockedData, _round_up
from mlease_tpu_torch.core.vocab import FeatureVocab


def vocab_from_names(names: Sequence[str], has_intercept: bool = True) -> FeatureVocab:
    """Frozen vocab over first-occurrence-ordered names (the decoder interns
    in first-occurrence order, matching LibLinearDataset.java:434-443)."""
    v = FeatureVocab(has_intercept=has_intercept)
    for n in names:
        v.add(n)
    return v.freeze()


def prepare_columnar(decoded, nblocks: int, *, num_click_replicates: int = 1,
                     seed: int = 0):
    """Vectorized RegressionPrepare: returns (row_ids, partitions, weights).

    row_ids indexes into the decoded arrays (positives appear
    num_click_replicates times); weights are the adjusted per-output-row
    weights (positive weight / replicates, RegressionPrepare.java:158-162).
    When decoded.keys is set (map.key column), partitions come from it and no
    replication happens (RegressionPrepare.java:171-188).
    """
    n = decoded.num_rows
    response = decoded.response
    weight = decoded.weight.astype(np.float64)
    is_pos = response == 1
    w_out = np.where(is_pos, weight / num_click_replicates, weight)

    if decoded.keys is not None:
        partitions = np.asarray([int(k) for k in decoded.keys], np.int64)
        if partitions.min() < 0 or partitions.max() >= nblocks:
            raise ValueError(
                f"Map key is wrong! key has to be in the range of "
                f"[0,{nblocks - 1}].")
        return np.arange(n, dtype=np.int64), partitions, w_out

    rng = np.random.default_rng(seed)
    base = (rng.random(n) * nblocks).astype(np.int64)

    reps = np.where(is_pos, num_click_replicates, 1)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), reps)
    # consecutive partitions (mod nblocks) per replica
    offsets = np.concatenate([np.arange(r) for r in reps]) if n else np.zeros(0, np.int64)
    partitions = (base[row_ids] + offsets) % nblocks
    return row_ids, partitions, w_out[row_ids]


PACK_CHUNK_ROWS = 1 << 22   # pack_blocks_columnar's rows at a time


def pack_blocks_columnar(decoded, row_ids: np.ndarray, partitions: np.ndarray,
                         weights: np.ndarray, vocab: FeatureVocab, *,
                         nblocks: int, bias: float = 1.0, dtype=np.float32,
                         row_multiple: int = 8,
                         nnz_multiple: int = 8) -> BlockedData:
    """CSR rows + partition assignment -> stacked padded BlockedData."""
    n_out = len(row_ids)
    row_start = decoded.row_start
    nnz_per_row = (row_start[row_ids + 1] - row_start[row_ids]).astype(np.int64)
    has_icpt = vocab.intercept_index is not None and bias > 0
    extra = 1 if has_icpt else 0

    K = _round_up(max(int(nnz_per_row.max(initial=0)) + extra, 1), nnz_multiple)
    counts = np.bincount(partitions, minlength=nblocks)
    R = _round_up(max(int(counts.max(initial=0)), 1), row_multiple)
    n_dim = vocab.size

    indices = np.zeros((nblocks, R, K), np.int32)
    values = np.zeros((nblocks, R, K), dtype)
    y = np.ones((nblocks, R), dtype)
    weight_arr = np.zeros((nblocks, R), dtype)
    offset_arr = np.zeros((nblocks, R), dtype)
    present = np.zeros((nblocks, n_dim), bool)

    # stable position of each output row within its block
    order = np.argsort(partitions, kind="stable")
    slot = np.empty(n_out, np.int64)
    pos = 0
    block_of_sorted = partitions[order]
    boundaries = np.searchsorted(block_of_sorted, np.arange(nblocks + 1))
    for b in range(nblocks):
        lo, hi = boundaries[b], boundaries[b + 1]
        slot[order[lo:hi]] = np.arange(hi - lo)

    feat_id = decoded.feat_id
    feat_val = decoded.feat_val
    resp = decoded.response
    off = decoded.offset

    # fully vectorized ragged-CSR -> padded-ELL expansion: gather each output
    # row's k-th nonzero via clipped flat offsets, mask the padding lanes;
    # PACK_CHUNK_ROWS output rows at a time (each row is written once, so
    # the chunks give the one-pass result; the JAX package expands all rows
    # at once, whose (n_out, K) int64 temporaries reach 12 GB each at 100M
    # rows)
    k_grid = np.arange(K - extra, dtype=np.int64)[None, :]       # (1, K-extra)
    for lo in range(0, n_out, PACK_CHUNK_ROWS):
        rows = slice(lo, min(lo + PACK_CHUNK_ROWS, n_out))
        ids = row_ids[rows]
        starts = row_start[ids]                                  # (n,)
        nnz = nnz_per_row[rows]                                  # (n,)
        lane_valid = k_grid < nnz[:, None]                       # (n, K-extra)
        flat = np.minimum(starts[:, None] + k_grid,
                          len(feat_id) - 1 if len(feat_id) else 0)
        if len(feat_id):
            row_idx = np.where(lane_valid, feat_id[flat], 0).astype(np.int32)
            row_val = np.where(lane_valid, feat_val[flat], 0.0).astype(dtype)
        else:
            row_idx = np.zeros((len(ids), K - extra), np.int32)
            row_val = np.zeros((len(ids), K - extra), dtype)
        del flat, lane_valid

        b_ix = partitions[rows]
        r_ix = slot[rows]
        indices[b_ix, r_ix, :K - extra] = row_idx
        values[b_ix, r_ix, :K - extra] = row_val
        del row_idx, row_val
        if has_icpt:
            indices[b_ix, r_ix, nnz] = vocab.intercept_index
            values[b_ix, r_ix, nnz] = bias
        y[b_ix, r_ix] = np.where(resp[ids] == 1, 1.0, -1.0).astype(dtype)
        weight_arr[b_ix, r_ix] = weights[rows].astype(dtype)
        offset_arr[b_ix, r_ix] = off[ids]

    for b in range(nblocks):
        real = weight_arr[b] > 0
        cols = indices[b][real].ravel()
        vals = values[b][real].ravel()
        present[b, cols[vals != 0]] = True
        if has_icpt and counts[b] > 0:
            present[b, vocab.intercept_index] = True

    return BlockedData(indices=indices, values=values, y=y, weight=weight_arr,
                       offset=offset_arr, present=present,
                       nrows=counts.astype(np.int32), nblocks=nblocks,
                       dim=n_dim)


def decode_files_parallel(paths, *, ignore_value: bool = False,
                          map_key: str = "", max_workers: int = 8):
    """Decode several Avro files concurrently. The C++ decoder runs with the
    GIL released (ctypes), so plain threads give real parallelism. Two levels
    compose: file-level threads here, and block-level threads inside each
    file's decode (mlease_decode_blocks_mt) — the per-file width is the cpu
    budget divided by the number of concurrently decoded files."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from mlease_tpu_torch.io import fast_decode

    ncpu = _os.cpu_count() or 1
    if len(paths) == 1:
        return [fast_decode.decode_file(paths[0], ignore_value=ignore_value,
                                        map_key=map_key, nthreads=0)]
    file_workers = min(max_workers, len(paths))
    per_file = max(1, min(ncpu // file_workers, 8))
    with ThreadPoolExecutor(max_workers=file_workers) as ex:
        return list(ex.map(
            lambda p: fast_decode.decode_file(p, ignore_value=ignore_value,
                                              map_key=map_key,
                                              nthreads=per_file), paths))


def merge_decoded(parts) -> "object":
    """Concatenate per-file DecodedRows into one, remapping each file's
    interned feature ids onto a merged first-occurrence vocabulary."""
    from mlease_tpu_torch.io.fast_decode import DecodedRows

    if len(parts) == 1:
        return parts[0]
    merged_names: list[str] = []
    merged_index: dict[str, int] = {}
    remapped_ids = []
    for d in parts:
        remap = np.empty(len(d.vocab_names), np.int32)
        for local_id, name in enumerate(d.vocab_names):
            gid = merged_index.get(name)
            if gid is None:
                gid = len(merged_names)
                merged_index[name] = gid
                merged_names.append(name)
            remap[local_id] = gid
        remapped_ids.append(remap[d.feat_id] if len(d.feat_id) else d.feat_id)

    offsets = np.cumsum([0] + [len(d.feat_id) for d in parts])
    row_start = np.concatenate(
        [d.row_start[:-1] + off for d, off in zip(parts, offsets)]
        + [np.array([offsets[-1]], np.int64)])
    keys = None
    if parts[0].keys is not None:
        keys = [k for d in parts for k in d.keys]
    return DecodedRows(
        response=np.concatenate([d.response for d in parts]),
        weight=np.concatenate([d.weight for d in parts]),
        offset=np.concatenate([d.offset for d in parts]),
        row_start=row_start,
        feat_id=np.concatenate(remapped_ids),
        feat_val=np.concatenate([d.feat_val for d in parts]),
        vocab_names=merged_names, keys=keys)


def keyed_rows_from_decoded(decoded) -> dict[str, list[dict]]:
    """Columnar decode (with map_key) -> {key -> canonical rows} for the
    per-key trainers. Avoids the pure-Python Avro decode, which dominates
    per-item ingest time; the canonical-row dicts themselves are cheap."""
    if decoded.keys is None:
        raise ValueError("decode was not run with a map_key")
    out: dict[str, list[dict]] = {}
    names = decoded.vocab_names
    rs = decoded.row_start
    for i, key in enumerate(decoded.keys):
        s, e = rs[i], rs[i + 1]
        feats = [(names[decoded.feat_id[j]], float(decoded.feat_val[j]))
                 for j in range(s, e)]
        out.setdefault(key, []).append({
            "response": int(decoded.response[i]),
            "features": feats,
            "weight": float(decoded.weight[i]),
            "offset": float(decoded.offset[i]),
        })
    return out


def load_keyed_rows(paths: Sequence[str] | str, item_key: str, *,
                    ignore_value: bool = False) -> dict[str, list[dict]]:
    """Native per-key ingest: decode + group by the item/map key column."""
    if isinstance(paths, str):
        paths = [paths]
    decoded = merge_decoded(decode_files_parallel(
        paths, ignore_value=ignore_value, map_key=item_key))
    return keyed_rows_from_decoded(decoded)


def load_blocked_data(paths: Sequence[str], nblocks: int, *,
                      num_click_replicates: int = 1, ignore_value: bool = False,
                      seed: int = 0, bias: float = 1.0, dtype=np.float32):
    """Full native ingest of one or more Avro files -> (BlockedData, vocab).

    Multiple files decode independently (parallelizable across hosts) and
    merge into one global vocabulary in first-occurrence order.
    """
    if isinstance(paths, str):
        paths = [paths]
    decoded = merge_decoded(decode_files_parallel(
        paths, ignore_value=ignore_value))
    vocab = vocab_from_names(decoded.vocab_names)
    row_ids, partitions, weights = prepare_columnar(
        decoded, nblocks, num_click_replicates=num_click_replicates, seed=seed)
    data = pack_blocks_columnar(decoded, row_ids, partitions, weights, vocab,
                                nblocks=nblocks, bias=bias, dtype=dtype)
    return data, vocab
