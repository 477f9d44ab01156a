"""Held-out log-likelihood aggregation over scored records.

TPU-native RegressionTestLoglik (reference:
src/main/java/com/linkedin/mlease/regression/jobs/RegressionTestLoglik.java:120-177):
per record loglik = -log1p(exp(-+pred)) * weight (sign by response), aggregated
to a single {key: "averageTestLoglik", testLoglik: sum/sum_w, count: sum_w}
record under <out>/lambda-<l>/_loglik/ (and best-model/_loglik). The
map-combine-reduce of the reference collapses to one vectorized numpy pass.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping, Sequence

import numpy as np

from mlease_tpu_torch.io import avro, schemas
from mlease_tpu_torch.io.records import get_response


def record_loglik(response: int, pred: float, weight: float = 1.0) -> float:
    """Weighted Bernoulli loglik of one scored record
    (RegressionTestLoglik.java:138-145). log1p(exp(x)) is computed as
    logaddexp(0, x): the reference's direct form overflows to -inf for
    |pred| beyond ~709 — a flaw we fix rather than copy."""
    if response not in (1, 0, -1):
        raise ValueError("response should be 1,0 or -1!")
    if response == 1:
        return float(-np.logaddexp(0.0, -pred) * weight)
    return float(-np.logaddexp(0.0, pred) * weight)


def aggregate_loglik(records: Iterable[Mapping]) -> dict:
    """Scored records -> the averageTestLoglik output record."""
    responses, preds, weights = [], [], []
    for rec in records:
        responses.append(get_response(rec))
        preds.append(float(rec["pred"]))
        w = rec.get("weight")
        weights.append(1.0 if w is None else float(w))
    if not preds:
        return {"key": "averageTestLoglik", "testLoglik": 0.0, "count": 0.0}
    r = np.asarray(responses)
    if not np.isin(r, (1, 0, -1)).all():
        raise ValueError("response should be 1,0 or -1!")
    p = np.asarray(preds)
    w = np.asarray(weights)
    yz = np.where(r == 1, p, -p)
    ll = -np.logaddexp(0.0, -yz) * w  # overflow-safe log1p(exp(-yz))
    n = float(w.sum())
    return {"key": "averageTestLoglik",
            "testLoglik": float(ll.sum() / n), "count": n}


def run_test_loglik(scored_base: str, out_base: str,
                    lambdas: Sequence[float] | Sequence[str], *,
                    include_best: bool = True) -> dict[str, dict]:
    """Aggregate each <scored_base>/lambda-<l>/ (and best-model/) into
    <out_base>/.../_loglik/part-r-00000.avro. Returns {name -> loglik record}."""
    results = {}

    def one(name: str, subdir: str):
        in_path = os.path.join(scored_base, subdir)
        if not os.path.exists(in_path):
            return
        agg = aggregate_loglik(avro.read_records(in_path))
        out_path = os.path.join(out_base, subdir, "_loglik",
                                "part-r-00000.avro")
        avro.write_records(out_path, schemas.REGRESSION_TEST_LOGLIK_OUTPUT,
                           [agg])
        results[name] = agg

    for lam in lambdas:
        one(str(lam), f"lambda-{lam}")
    if include_best:
        one("best-model", "best-model")
    return results
