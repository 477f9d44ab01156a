"""Record-level normalization of raw training rows.

Replicates the reference's field handling exactly:
  * response aliasing click/response/label, bool -> int
    (reference: src/main/java/com/linkedin/mlease/utils/Util.java:309-337)
  * feature key = name + "\\u0001" + term when term is non-empty
    (reference: LibLinearDataset.java:425-427, LinearModel.java:530-532)
  * weight default 1.0, offset default 0.0 (LibLinearDataset.java:340-359)
  * response 0 -> -1 for training (LibLinearDataset.java:333-335)
"""

from __future__ import annotations

from typing import Any, Mapping

SEP = ""
INTERCEPT_NAME = "(INTERCEPT)"  # reference: LibLinearDataset.java:92


def get_response(record: Mapping[str, Any]) -> int:
    """click/response/label aliasing; later aliases win, as in the reference
    (Util.java:309-320 checks click, then response, then label, overwriting)."""
    response = None
    for field in ("click", "response", "label"):
        v = record.get(field)
        if v is not None:
            response = v
    if response is None:
        raise ValueError(
            "Data should contain one field of the three: response, click or label!")
    if isinstance(response, bool):
        return 1 if response else 0
    if isinstance(response, int):
        return response
    raise ValueError("Response/Click/Label column should be either boolean or int32!")


def feature_key(name: str, term: str | None) -> str:
    if term is None or term == "":
        return name
    return f"{name}{SEP}{term}"


def split_feature_key(key: str) -> tuple[str, str]:
    """Inverse of feature_key, for writing Avro {name, term, value} models
    (reference: LinearModel.toAvro, LinearModel.java:620-650)."""
    if SEP in key:
        name, term = key.split(SEP, 1)
        return name, term
    return key, ""


def normalize_row(record: Mapping[str, Any], ignore_value: bool = False) -> dict:
    """Raw Avro record (possibly with Pig-style null unions already stripped
    by the decoder) -> canonical {response, features:[(key, value)], weight,
    offset} row. Raises on malformed rows like RegressionPrepareMapper
    (reference: RegressionPrepare.java:112-160)."""
    response = get_response(record)
    if response not in (-1, 0, 1):
        raise ValueError(f"response = {response} (only 1, 0, -1 are allowed)")
    raw_features = record.get("features")
    if raw_features is None:
        raise ValueError("features is null")
    if not isinstance(raw_features, list):
        raise ValueError("features is not a list")
    feats = []
    for i, f in enumerate(raw_features):
        if not isinstance(f, Mapping):
            raise ValueError(f"features[{i}] is not a record")
        name = f.get("name")
        if name is None:
            raise ValueError(f"features[{i}].name is null")
        term = f.get("term")
        value = 1.0
        if not ignore_value:
            v = f.get("value")
            value = 1.0 if v is None else float(v)
        feats.append((feature_key(str(name), None if term is None else str(term)),
                      value))
    weight = record.get("weight")
    weight = 1.0 if weight is None else float(weight)
    if weight < 0:
        raise ValueError(f"weight = {weight} (weight cannot < 0)")
    offset = record.get("offset")
    offset = 0.0 if offset is None else float(offset)
    return {"response": response, "features": feats,
            "weight": weight, "offset": offset}


def row_to_prepare_record(key: str, row: Mapping[str, Any]) -> dict:
    """Canonical row -> RegressionPrepareOutput Avro record."""
    features = []
    for k, v in row["features"]:
        name, term = split_feature_key(k)
        features.append({"name": name, "term": term, "value": float(v)})
    return {
        "key": key,
        "response": int(row["response"]),
        "features": features,
        "weight": float(row["weight"]),
        "offset": float(row["offset"]),
    }


def read_json_rows(path: str, ignore_value: bool = False) -> list[dict]:
    """JSON-lines input: one {response/click/label, features:[{name,term,
    value}], weight?, offset?} object per line (the reference's JSON ingest,
    LibLinearDataset.addInstanceJSON, LibLinearDataset.java:241-310)."""
    import json

    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(normalize_row(json.loads(line),
                                          ignore_value=ignore_value))
            except (ValueError, KeyError) as e:
                raise ValueError(
                    f"Error found when processing {path}:{lineno}: {e}") from e
    return rows


def prepare_record_to_row(record: Mapping[str, Any],
                          ignore_value: bool = False) -> dict:
    """RegressionPrepareOutput record -> canonical row."""
    feats = []
    for f in record["features"]:
        value = 1.0 if ignore_value else float(f["value"])
        feats.append((feature_key(f["name"], f.get("term")), value))
    return {
        "response": int(record["response"]),
        "features": feats,
        "weight": float(record["weight"]),
        "offset": float(record["offset"]),
    }
