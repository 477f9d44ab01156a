"""LinearModel: sparse named-coefficient linear model ADT.

Host-side counterpart of the reference's model representation
(reference: src/main/java/com/linkedin/mlease/models/LinearModel.java:39):
a {feature-key -> coefficient} map plus a separately-stored intercept, with
linear combination, evaluation (including the click-replicate intercept
correction), and Avro (de)serialization in the reference's
{name, term, value} list format. On device everything is dense vectors; this
class is the interop boundary (model files, consensus bookkeeping in tests).
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping

from mlease_tpu_torch.io.records import INTERCEPT_NAME, feature_key, split_feature_key


class LinearModel:
    __slots__ = ("coefficients", "intercept")

    def __init__(self, coefficients: Mapping[str, float] | None = None,
                 intercept: float = 0.0):
        self.coefficients: dict[str, float] = dict(coefficients or {})
        self.intercept = float(intercept)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_avro(cls, model_list: Iterable[Mapping[str, Any]],
                  intercept_key: str = INTERCEPT_NAME) -> "LinearModel":
        """From the Avro [{name, term, value}] list; the entry whose composed
        key equals `intercept_key` becomes the intercept (reference:
        LinearModel.java:87-156)."""
        coeffs: dict[str, float] = {}
        intercept = 0.0
        for item in model_list:
            key = feature_key(item["name"], item.get("term"))
            if key == intercept_key:
                intercept = float(item["value"])
            else:
                coeffs[key] = float(item["value"])
        return cls(coeffs, intercept)

    @classmethod
    def from_dense(cls, vec, vocab, drop_zeros: bool = True) -> "LinearModel":
        """Dense device vector (vocab coordinates) -> sparse named model."""
        coeffs = {}
        intercept = 0.0
        icpt = vocab.intercept_index
        for i in range(vocab.size):
            v = float(vec[i])
            if i == icpt:
                intercept = v
            elif not (drop_zeros and v == 0.0):
                coeffs[vocab.name(i)] = v
        return cls(coeffs, intercept)

    def to_avro(self, intercept_key: str = INTERCEPT_NAME) -> list[dict]:
        """-> Avro [{name, term, value}] list, intercept first (reference:
        LinearModel.toAvro, LinearModel.java:620-650)."""
        out = []
        name, term = split_feature_key(intercept_key)
        out.append({"name": name, "term": term, "value": float(self.intercept)})
        for k, v in self.coefficients.items():
            name, term = split_feature_key(k)
            out.append({"name": name, "term": term, "value": float(v)})
        return out

    def to_dense(self, vocab, out=None):
        import numpy as np

        if out is None:
            out = np.zeros(vocab.size, dtype=np.float64)
        else:
            out[:] = 0.0
        for k, v in self.coefficients.items():
            idx = vocab.get(k)
            if idx is not None:
                out[idx] = v
        if vocab.intercept_index is not None:
            out[vocab.intercept_index] = self.intercept
        return out

    def copy(self) -> "LinearModel":
        return LinearModel(self.coefficients, self.intercept)

    # -- algebra -----------------------------------------------------------
    def rescale(self, factor: float) -> None:
        for k in self.coefficients:
            self.coefficients[k] *= factor
        self.intercept *= factor

    def linear_combine(self, a: float, b: float, other: "LinearModel",
                       bmap: Mapping[str, float] | None = None) -> None:
        """self = a*self + b*other, with optional per-coefficient override of
        b from bmap (reference: LinearModel.linearCombine,
        LinearModel.java:181-230; bmap carries the per-feature z-update
        weights from lambda.map)."""
        keys = set(self.coefficients) | set(other.coefficients)
        for k in keys:
            bk = bmap[k] if bmap is not None and k in bmap else b
            v = a * self.coefficients.get(k, 0.0) + bk * other.coefficients.get(k, 0.0)
            self.coefficients[k] = v
        self.intercept = a * self.intercept + b * other.intercept

    def max_abs_value(self) -> float:
        """max(|intercept|, max |coef|) — the reference's convergence metric
        (LinearModel.java:728-740)."""
        m = abs(self.intercept)
        for v in self.coefficients.values():
            m = max(m, abs(v))
        return m

    def filterout(self, key_substring: str) -> None:
        self.coefficients = {k: v for k, v in self.coefficients.items()
                             if key_substring not in k}

    def clear(self) -> None:
        self.coefficients.clear()
        self.intercept = 0.0

    # -- evaluation ---------------------------------------------------------
    def eval_features(self, features: Iterable[tuple[str, float]],
                      num_click_replicates: int = 1) -> float:
        """x'beta with the click-replicate intercept correction
        -log(c - 1 + c*exp(-intercept)) (reference: LinearModel.eval,
        LinearModel.java:241-257; for c=1 this reduces to the intercept)."""
        c = num_click_replicates
        result = -math.log(c - 1 + c * math.exp(-self.intercept))
        for k, v in features:
            coef = self.coefficients.get(k)
            if coef is not None:
                result += coef * v
        return result

    def eval_instance(self, row: Mapping[str, Any], loglik: bool = False,
                      num_click_replicates: int = 1) -> float:
        """Canonical row -> x'beta + offset, or the weighted Bernoulli test
        log-likelihood when loglik=True (reference: LinearModel.evalInstanceAvro,
        LinearModel.java:491-553)."""
        xbeta = row.get("offset", 0.0) + self.eval_features(
            row["features"], num_click_replicates)
        if not loglik:
            return xbeta
        y = row["response"]
        weight = row.get("weight", 1.0)
        if y == 1:
            return -math.log1p(math.exp(-xbeta)) * weight
        return -math.log1p(math.exp(xbeta)) * weight

    def to_string(self, intercept_key: str = "0", inner_delim: str = "=",
                  outer_delim: str = " ") -> str:
        """"key1=value1 key2=value2 ..." text form (reference:
        LinearModel.toString, LinearModel.java:580-610)."""
        parts = [f"{intercept_key}{inner_delim}{self.intercept!r}"]
        for k, v in self.coefficients.items():
            parts.append(f"{k}{inner_delim}{v!r}")
        return outer_delim.join(parts)

    @classmethod
    def from_string(cls, text: str, intercept_key: str = "0",
                    inner_delim: str = "=",
                    outer_delim: str = " ") -> "LinearModel":
        coeffs: dict[str, float] = {}
        intercept = 0.0
        for tok in text.split(outer_delim):
            tok = tok.strip()
            if not tok:
                continue
            k, _, v = tok.partition(inner_delim)
            if k == intercept_key:
                intercept = float(v)
            else:
                coeffs[k] = float(v)
        return cls(coeffs, intercept)

    # -- misc ----------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.coefficients)

    def __repr__(self) -> str:
        return (f"LinearModel(n={len(self.coefficients)}, "
                f"intercept={self.intercept:.6g})")


# ----------------------------------------------------------------------------
# Model file helpers — the reference's {key -> model} Avro files
# (reference: utils/LinearModelUtils.java:39-86)
# ----------------------------------------------------------------------------

def write_model_file(path: str, models: Mapping[str, LinearModel],
                     intercept_key: str = INTERCEPT_NAME) -> None:
    from mlease_tpu_torch.io import avro, schemas

    records = [{"key": k, "model": m.to_avro(intercept_key)}
               for k, m in models.items()]
    avro.write_records(path, schemas.LINEAR_MODEL, records)


def read_model_file(path: str,
                    intercept_key: str = INTERCEPT_NAME) -> dict[str, LinearModel]:
    from mlease_tpu_torch.io import avro

    out: dict[str, LinearModel] = {}
    for rec in avro.read_records(path):
        out[rec["key"]] = LinearModel.from_avro(rec["model"], intercept_key)
    return out


def mean_model(models: Mapping[str, LinearModel], nblocks: int,
               nlambdas: int, strict: bool = True) -> dict[str, LinearModel]:
    """Average per-lambda block models keyed "lambda#block" into {lambda ->
    mean model} (reference: LinearModelUtils.meanModel,
    utils/LinearModelUtils.java:68-86, including the "Some models failed!"
    count check)."""
    if strict and len(models) != nblocks * nlambdas:
        raise ValueError(
            f"Some models failed! got {len(models)} models, "
            f"expected {nblocks * nlambdas}")
    sums: dict[str, LinearModel] = {}
    for key, model in models.items():
        lam = key.split("#", 1)[0]
        acc = sums.setdefault(lam, LinearModel())
        acc.linear_combine(1.0, 1.0 / nblocks, model)
    return sums
