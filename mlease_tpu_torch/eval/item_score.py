"""Per-item model scoring + per-model-key loglik.

Port of mlease_tpu/eval/item_score.py, the counterpart of ItemModelTest /
ItemModelTestLoglik (reference: ItemModelTest.java:136-212,
ItemModelTestLoglik.java:60-142). The reference shuffles test rows by item
key and has each reducer load only its hash-shard of models
(ReadLinearModelConsumer with Math.abs(itemKey.hashCode()) % nReducers ==
taskId, ItemModelTest.java:157-171, ReadLinearModelConsumer.java:56-72); rows
whose item has no model score with an empty model (:193-197).

Here scoring is a vectorized batch job: records are columnarized once, the
(item, feature) -> coefficient join is a sorted-key numpy merge on the host,
and the per-record dot products for all model prefixes are one segment sum
on the device: `segment_sum_sorted`, the hand-written sorted-stream kernel
of ops/segment_sum.py, over the (P, N) per-nonzero contributions with the
record index as the segment id (the stream is in record order, so it is
sorted by construction). Model sets larger than host memory stream
shard-by-shard via `read_model_file_sharded` using the reference's exact
Java-hash shard assignment, so model files written by the reference shard
identically here.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.eval.loglik import record_loglik
from mlease_tpu_torch.eval.score import remove_union
from mlease_tpu_torch.io import avro, schemas
from mlease_tpu_torch.io.records import get_response, normalize_row


def java_string_hash(s: str) -> int:
    """Java String.hashCode (h = 31*h + c over UTF-16 code units), with
    int32 wraparound — the hash the reference shards models by
    (ReadLinearModelConsumer.java:76)."""
    h = 0
    b = s.encode("utf-16-be")
    for i in range(0, len(b), 2):
        c = (b[i] << 8) | b[i + 1]
        h = (31 * h + c) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def item_shard(item: str, nshards: int) -> int:
    """Math.abs(hashCode) % nshards (ItemModelTest.java:131,
    ReadLinearModelConsumer.java:76). Java's Math.abs(Integer.MIN_VALUE) is
    negative; that pathological hash is mapped to shard 0 here (the reference
    would crash with ArrayIndexOutOfBounds in the same situation)."""
    h = abs(java_string_hash(item))
    return (h % nshards) if h >= 0 else 0


def read_model_file_sharded(path: str, *, lambda_prefix: str | None = None,
                            shard: int | None = None,
                            nshards: int | None = None,
                            intercept_key: str | None = None
                            ) -> dict[str, LinearModel]:
    """Stream a {key -> model} Avro file keeping only this shard's models
    (reference: ReadLinearModelConsumer.java:54-82): key must contain
    `lambda_prefix` (e.g. "1.0#") and the item part after '#' must hash to
    `shard` of `nshards`."""
    from mlease_tpu_torch.io.records import INTERCEPT_NAME

    ik = intercept_key if intercept_key is not None else INTERCEPT_NAME
    out: dict[str, LinearModel] = {}
    for rec in avro.read_records(path):
        key = rec.get("key")
        model = rec.get("model")
        if key is None or model is None:
            continue
        key = str(key)
        if lambda_prefix is not None and lambda_prefix not in key:
            continue
        if shard is not None:
            token = key.split("#")
            if len(token) < 2:
                continue
            if item_shard(token[1], nshards) != shard:
                continue
        out[key] = LinearModel.from_avro(model, ik)
    return out


# ---------------------------------------------------------------------------
# Vectorized batch scorer
# ---------------------------------------------------------------------------

def _columnarize(rows: Sequence[Mapping]) -> tuple:
    """Normalized rows -> (row_ids, keys, vals, offsets): one flat pass."""
    row_ids: list[int] = []
    keys: list[str] = []
    vals: list[float] = []
    offsets = np.zeros(len(rows), np.float64)
    for i, row in enumerate(rows):
        offsets[i] = row.get("offset", 0.0)
        feats = row["features"]
        row_ids.extend([i] * len(feats))
        for k, v in feats:
            keys.append(k)
            vals.append(v)
    return (np.asarray(row_ids, np.int64),
            np.asarray(keys, dtype=object) if keys else np.empty(0, object),
            np.asarray(vals, np.float64), offsets)


def _segment_dot(contrib: np.ndarray, row_ids: np.ndarray, nrows: int,
                 device) -> np.ndarray:
    """(P, N) per-nonzero contributions -> (P, R) per-record sums on the
    device, through the sorted-stream segment-sum kernel. `_columnarize`
    emits row_ids in record order; that is checked here once."""
    import torch

    from mlease_tpu_torch.device import resolve_device
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted

    if nrows >= 2**31:
        raise ValueError("record ids must fit int32")
    if len(row_ids) > 1 and bool(np.any(row_ids[1:] < row_ids[:-1])):
        raise ValueError("row_ids must be non-decreasing (record order)")
    dev = resolve_device(device)
    out = segment_sum_sorted(
        torch.as_tensor(np.ascontiguousarray(contrib), device=dev),
        torch.as_tensor(row_ids.astype(np.int32), device=dev), nrows)
    return out.cpu().numpy()


def score_item_batch(models: Mapping[str, LinearModel],
                     rows: Sequence[Mapping], items: Sequence[str],
                     model_prefixes: Sequence[str],
                     device="cuda") -> np.ndarray:
    """Score every row with each "prefix#item" model -> (R, P) float64 preds.

    The (item, feature) -> coefficient join is a vectorized sorted-key merge;
    the per-record accumulation is one segment sum over all prefixes, on
    `device`.
    Missing models behave as the empty model (ItemModelTest.java:193-197).
    """
    R, P = len(rows), len(model_prefixes)
    preds = np.zeros((R, P), np.float64)
    if R == 0:
        return preds

    row_ids, keys, vals, offsets = _columnarize(rows)
    items_arr = np.asarray([str(it) for it in items], dtype=object)
    uniq_items, item_local = np.unique(items_arr, return_inverse=True)
    I = len(uniq_items)

    if len(keys):
        uniq_keys, key_code = np.unique(keys, return_inverse=True)
    else:
        uniq_keys, key_code = np.empty(0, object), np.empty(0, np.int64)
    ncodes = max(len(uniq_keys), 1)

    # nonzero pair ids: item_local * ncodes + feature_code
    nz_pair = item_local[row_ids] * ncodes + key_code

    intercepts = np.zeros((P, I), np.float64)
    coef = np.zeros((P, len(keys)), np.float64)
    for p, prefix in enumerate(model_prefixes):
        # model side: flat (pair_id, coefficient) arrays for this prefix
        m_pairs: list[np.ndarray] = []
        m_vals: list[np.ndarray] = []
        for i, item in enumerate(uniq_items):
            model = models.get(f"{prefix}#{item}")
            if model is None:
                continue
            intercepts[p, i] = model.intercept
            # (a batch whose records carry no feature at all has no code
            # to join on; the JAX package indexes an empty array there)
            if not model.coefficients or not len(uniq_keys):
                continue
            mk = np.asarray(list(model.coefficients.keys()), object)
            mv = np.fromiter(model.coefficients.values(), np.float64,
                             len(model.coefficients))
            # vectorized key -> code lookup; coefficients on features absent
            # from the record batch can never be touched — drop them
            pos = np.searchsorted(uniq_keys, mk)
            pos_c = np.clip(pos, 0, ncodes - 1)
            hit = (pos < len(uniq_keys)) & (uniq_keys[pos_c] == mk)
            if hit.any():
                m_pairs.append(i * ncodes + pos_c[hit])
                m_vals.append(mv[hit])
        if m_pairs:
            mp = np.concatenate(m_pairs)
            mv = np.concatenate(m_vals)
            order = np.argsort(mp, kind="stable")
            mp, mv = mp[order], mv[order]
            # merge: every record nonzero finds its coefficient (or 0)
            loc = np.searchsorted(mp, nz_pair)
            loc_c = np.clip(loc, 0, len(mp) - 1)
            hit = (loc < len(mp)) & (mp[loc_c] == nz_pair)
            coef[p, hit] = mv[loc_c[hit]]

    if len(keys):
        dots = _segment_dot(coef * vals[None, :], row_ids, R,
                            device)                          # (P, R)
    else:
        dots = np.zeros((P, R))
    preds = dots.T + offsets[:, None] + intercepts[:, item_local].T
    return preds


def score_item_records(models: Mapping[str, LinearModel],
                       records: Sequence[Mapping], *, item_key: str,
                       model_prefixes: Sequence[str],
                       ignore_value: bool = False,
                       device="cuda") -> list[dict]:
    """Score each record with every model "prefix#item" for its item.

    Returns records + {"pred": {prefix: xbeta}} (float32 like the reference's
    `(float) model.evalInstanceAvro`, ItemModelTest.java:182-211).
    """
    items = []
    rows = []
    for rec in records:
        item = rec.get(item_key)
        if item is None:
            raise ValueError(f"item key column {item_key!r} missing in record")
        items.append(str(item))
        rows.append(normalize_row(rec, ignore_value=ignore_value))

    preds = score_item_batch(models, rows, items, model_prefixes,
                             device=device)
    out = []
    for i, rec in enumerate(records):
        r = dict(rec)
        r["pred"] = {prefix: float(np.float32(preds[i, p]))
                     for p, prefix in enumerate(model_prefixes)}
        out.append(r)
    return out


def item_test_output_schema(input_schema: Any) -> dict:
    base = remove_union(input_schema)
    return {
        "type": "record",
        "name": "PerItemTestOutput",
        "namespace": "com.linkedin.lab.regression.avro",
        "fields": [{"name": f["name"], "type": f["type"]}
                   for f in base["fields"]]
        + [{"name": "pred", "type": {"type": "map", "values": "float"}}],
    }


def aggregate_item_loglik(scored_records: Iterable[Mapping]) -> list[dict]:
    """Per model key: {key, testLoglik: sum/sum_w, count: sum_w}
    (ItemModelTestLoglik.java:98-142)."""
    sums: dict[str, float] = {}
    counts: dict[str, float] = {}
    for rec in scored_records:
        response = get_response(rec)
        w = rec.get("weight")
        weight = 1.0 if w is None else float(w)
        for key, pred in rec["pred"].items():
            sums[key] = sums.get(key, 0.0) + record_loglik(response,
                                                           float(pred), weight)
            counts[key] = counts.get(key, 0.0) + weight
    return [{"key": k, "testLoglik": sums[k] / counts[k], "count": counts[k]}
            for k in sorted(sums)]


def run_item_model_test(records: Sequence[Mapping], input_schema: Any,
                        models: Mapping[str, LinearModel], out_path: str, *,
                        item_key: str, model_prefixes: Sequence[str],
                        ignore_value: bool = False,
                        device="cuda") -> list[dict]:
    scored = score_item_records(models, records, item_key=item_key,
                                model_prefixes=model_prefixes,
                                ignore_value=ignore_value, device=device)
    avro.write_records(out_path, item_test_output_schema(input_schema), scored)
    return scored


def run_item_model_test_sharded(records: Sequence[Mapping], input_schema: Any,
                                model_path: str, out_path: str, *,
                                item_key: str,
                                model_prefixes: Sequence[str] | None = None,
                                nshards: int, ignore_value: bool = False,
                                device="cuda") -> list[dict]:
    """Memory-bounded per-item scoring: models stream shard-by-shard
    (hash(item) % nshards, the reference's per-reducer model loading,
    ItemModelTest.java:157-171) and each shard's records score in one
    vectorized batch. Peak memory = one model shard + the record set.

    Output record order matches the input order (the reference's shuffle
    reorders rows by item hash instead — order is not part of the contract,
    but stable order makes diffing runs easy)."""
    if model_prefixes is None:
        prefixes: set[str] = set()
        for rec in avro.read_records(model_path):
            key = str(rec.get("key", ""))
            if "#" in key:
                prefixes.add(key.split("#", 1)[0])
        model_prefixes = sorted(prefixes)

    rows, items, shards = [], [], np.empty(len(records), np.int64)
    for i, rec in enumerate(records):
        item = rec.get(item_key)
        if item is None:
            raise ValueError(f"item key column {item_key!r} missing in record")
        item = str(item)
        items.append(item)
        rows.append(normalize_row(rec, ignore_value=ignore_value))
        shards[i] = item_shard(item, nshards)

    preds = np.zeros((len(records), len(model_prefixes)), np.float64)
    for k in range(nshards):
        sel = np.nonzero(shards == k)[0]
        if not len(sel):
            continue
        shard_models = read_model_file_sharded(model_path, shard=k,
                                               nshards=nshards)
        preds[sel] = score_item_batch(
            shard_models, [rows[i] for i in sel],
            [items[i] for i in sel], model_prefixes, device=device)

    scored = []
    for i, rec in enumerate(records):
        r = dict(rec)
        r["pred"] = {prefix: float(np.float32(preds[i, p]))
                     for p, prefix in enumerate(model_prefixes)}
        scored.append(r)
    avro.write_records(out_path, item_test_output_schema(input_schema), scored)
    return scored


def run_item_model_test_loglik(scored_records: Iterable[Mapping],
                               out_path: str) -> list[dict]:
    agg = aggregate_item_loglik(scored_records)
    avro.write_records(out_path, schemas.REGRESSION_TEST_LOGLIK_OUTPUT, agg)
    return agg
