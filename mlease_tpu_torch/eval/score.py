"""Batch scoring: append pred = x'beta (+offset) to every test record.

Port of mlease_tpu/eval/score.py (RegressionTest, reference:
src/main/java/com/linkedin/mlease/regression/jobs/RegressionTest.java): the
model is densified once onto the device and all records are scored in one
gather-reduce; the output keeps the reference's layout:

  <out>/lambda-<l>/part-r-00000.avro   per lambda (final-model)
  <out>/best-model/part-r-00000.avro   for the best model (sentinel lambda=-1,
                                       RegressionTest.java:91-105)

with schema = input schema (null-unions flattened, Util.removeUnion,
Util.java:339-375) + {pred: float}, records sorted by pred ascending (the
reducer's Pair<Float,..> sort, RegressionTest.java:165-175).
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import pack_rows
from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.core.vocab import FeatureVocab
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.io import avro
from mlease_tpu_torch.io.records import normalize_row


def remove_union(schema: Any) -> Any:
    """Replace every union by its first non-null branch, recursively
    (Util.removeUnion, Util.java:339-375)."""
    if isinstance(schema, list):
        for s in schema:
            if s != "null":
                return remove_union(s)
        return "null"
    if isinstance(schema, dict):
        t = schema.get("type")
        out = dict(schema)
        if t == "record":
            out["fields"] = [dict(f, type=remove_union(f["type"]))
                             for f in schema["fields"]]
        elif t == "array":
            out["items"] = remove_union(schema["items"])
        elif t == "map":
            out["values"] = remove_union(schema["values"])
        return out
    return schema


def model_vocab(model: LinearModel) -> tuple[FeatureVocab, np.ndarray]:
    """Vocab over the model's coefficient keys (+ intercept last) and the
    dense coefficient vector in those coordinates."""
    vocab = FeatureVocab(has_intercept=True)
    for k in model.coefficients:
        vocab.add(k)
    vocab.freeze()
    return vocab, model.to_dense(vocab)


def score_rows_device(model: LinearModel, rows: Sequence[Mapping],
                      dtype=None, device: str | torch.device = "cuda"
                      ) -> np.ndarray:
    """Vectorized device scoring: pred_i = offset_i + x_i'beta (+intercept via
    the bias column). Unknown features contribute 0, as in LinearModel.eval
    (LinearModel.java:247-255). float32 by default, as in mlease_tpu."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    if not rows:
        return np.zeros(0, np.float32)
    vocab, w = model_vocab(model)
    blk = pack_rows(rows, vocab)
    indices = torch.as_tensor(blk.indices, device=dev)
    values = torch.as_tensor(blk.values, dtype=dtype, device=dev)
    offset = torch.as_tensor(blk.offset, dtype=dtype, device=dev)
    w_t = torch.as_tensor(w, dtype=dtype, device=dev)
    preds = (values * w_t[indices]).sum(-1) + offset
    return preds.cpu().numpy()[:len(rows)]


def run_regression_test(input_records: Sequence[Mapping], input_schema: Any,
                        models: Mapping[str, LinearModel], out_base: str,
                        lambdas: Sequence[float] | Sequence[str], *,
                        best_model: LinearModel | None = None,
                        ignore_value: bool = False,
                        device: str | torch.device = "cuda") -> dict[str, str]:
    """Score all records with each lambda's model (+ best model), write the
    reference's per-lambda output layout. Returns {name -> output path}."""
    records = list(input_records)
    rows = [normalize_row(r, ignore_value=ignore_value) for r in records]

    base = remove_union(input_schema)
    out_schema = {
        "type": "record",
        "name": "AdmmTestOutput",
        "namespace": "com.linkedin.lab.regression.avro",  # RegressionTest.java:225
        "fields": [{"name": f["name"], "type": f["type"]}
                   for f in base["fields"]] + [{"name": "pred", "type": "float"}],
    }

    out_paths = {}

    def write_one(name: str, model: LinearModel, subdir: str):
        preds = score_rows_device(model, rows, device=device)
        order = np.argsort(preds, kind="stable")
        out = []
        for i in order:
            rec = dict(records[i])
            rec["pred"] = float(np.float32(preds[i]))
            out.append(rec)
        path = os.path.join(out_base, subdir, "part-r-00000.avro")
        avro.write_records(path, out_schema, out)
        out_paths[name] = path

    for lam in lambdas:
        key = str(lam)
        if key not in models:
            raise KeyError(f"no model for lambda {key}; have {sorted(models)}")
        write_one(key, models[key], f"lambda-{key}")
    if best_model is not None:
        write_one("best-model", best_model, "best-model")
    return out_paths
