"""The port's per-item scoring (mlease_tpu_torch.eval.item_score) and the
`item` -> `itemtest` CLI run as a whole, against the JAX package on the same
records; mirrors tests/test_item_score.py and tests/test_cli.py.

Tolerances: predictions to 1e-12 (float64 on the CPU; the two packages add
the same per-nonzero terms in another order). The CLI run trains in float64
with the Cholesky route, so models agree to rtol 1e-6 and the float32
predictions written to Avro to 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import mlease_tpu.eval.item_score as jscore
import mlease_tpu_torch.eval.item_score as tscore
from mlease_tpu.cli import main as jmain
from mlease_tpu.core.linear_model import (LinearModel as JLinearModel,
                                          write_model_file as jwrite_models)
from mlease_tpu.io import avro as javro
from mlease_tpu.io.records import normalize_row as jnormalize
from mlease_tpu_torch.cli import main as tmain
from mlease_tpu_torch.core.linear_model import (LinearModel,
                                                write_model_file)
from mlease_tpu_torch.io import avro as tavro
from mlease_tpu_torch.io.records import normalize_row
from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted

from test_item_score import _mk_records

torch.set_num_threads(1)

SCHEMA = {
    "type": "record", "name": "row", "fields": [
        {"name": "itemId", "type": "string"},
        {"name": "response", "type": "int"},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "feature", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "float"}]}}},
    ]}


def mk_models(cls):
    return {
        "1.0#itemA": cls({"f1": 0.5, "f2": -1.0}, intercept=0.3),
        "1.0#itemB": cls({"f1": 2.0}, intercept=-0.7),
        "2.0#itemA": cls({"f2": 1.5}, intercept=0.0),
        # itemC intentionally has no model for prefix 1.0
        "2.0#itemC": cls({"f3": 4.0}, intercept=1.0),
    }


def big_case(cls, n_records=3000):
    rng = np.random.default_rng(0)
    models = {f"{p}#it{i}": cls(
        {f"f{j}": float(rng.normal()) for j in range(5)},
        intercept=float(rng.normal())) for i in range(60) for p in ("1", "7")}
    records = [{
        "itemId": f"it{int(rng.integers(0, 75))}",   # some items modelless
        "response": int(rng.integers(0, 2)), "weight": 1.0,
        "offset": float(rng.normal() * 0.1),
        "features": [{"name": f"f{int(j)}", "term": "",
                      "value": float(rng.normal())}
                     for j in rng.choice(6, size=3, replace=False)]}
        for _ in range(n_records)]
    return models, records


def test_java_hash_and_shard_match_jax():
    for s in ["", "a", "abc", "hello", "Aa", "BB", "polygenelubricants",
              "日本語", "item42"]:
        assert tscore.java_string_hash(s) == jscore.java_string_hash(s)
        for n in (1, 3, 7):
            assert tscore.item_shard(s, n) == jscore.item_shard(s, n)
            assert 0 <= tscore.item_shard(s, n) < n
    assert tscore.java_string_hash("hello") == 99162322
    assert tscore.java_string_hash("polygenelubricants") == -2147483648


@pytest.mark.parametrize("case", ["small", "big"])
def test_score_item_batch_matches_jax(case):
    if case == "small":
        tm, jm, records = mk_models(LinearModel), mk_models(JLinearModel), \
            _mk_records()
        prefixes = ["1.0", "2.0"]
    else:
        tm, records = big_case(LinearModel)
        jm, _ = big_case(JLinearModel)
        prefixes = ["1", "7", "absent"]
    items = [r["itemId"] for r in records]
    got = tscore.score_item_batch(tm, [normalize_row(r) for r in records],
                                  items, prefixes, device="cpu")
    want = jscore.score_item_batch(jm, [jnormalize(r) for r in records],
                                   items, prefixes)
    assert got.shape == (len(records), len(prefixes))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # and against the scalar per-record evaluation
    empty = LinearModel()
    for i in range(0, len(records), max(1, len(records) // 50)):
        row = normalize_row(records[i])
        for p, prefix in enumerate(prefixes):
            m = tm.get(f"{prefix}#{items[i]}", empty)
            assert got[i, p] == pytest.approx(
                m.eval_instance(row, loglik=False), abs=1e-12)


def test_empty_batches_and_sorted_check():
    assert tscore.score_item_batch({}, [], [], ["1.0"],
                                   device="cpu").shape == (0, 1)
    rows = [{"features": [], "offset": 0.5}]
    got = tscore.score_item_batch(mk_models(LinearModel), rows, ["itemA"],
                                  ["1.0"], device="cpu")
    assert got[0, 0] == pytest.approx(0.8)
    with pytest.raises(ValueError, match="non-decreasing"):
        tscore._segment_dot(np.ones((1, 3)), np.array([0, 2, 1]), 3, "cpu")
    before = segment_sum_sorted.launches
    out = tscore._segment_dot(np.ones((2, 3)), np.array([0, 0, 2]), 4, "cpu")
    np.testing.assert_array_equal(out, [[2, 0, 1, 0]] * 2)
    assert segment_sum_sorted.launches == before      # no kernel on the CPU


def test_score_item_records_and_loglik_match_jax():
    tm, records = big_case(LinearModel, 500)
    jm, _ = big_case(JLinearModel, 500)
    got = tscore.score_item_records(tm, records, item_key="itemId",
                                    model_prefixes=["1", "7"], device="cpu")
    want = jscore.score_item_records(jm, records, item_key="itemId",
                                     model_prefixes=["1", "7"])
    assert [r["pred"] for r in got] == [r["pred"] for r in want]
    assert tscore.aggregate_item_loglik(got) == \
        jscore.aggregate_item_loglik(want)
    with pytest.raises(ValueError, match="item key column"):
        tscore.score_item_records(tm, records, item_key="nope",
                                  model_prefixes=["1"], device="cpu")
    extreme = [{"response": 1, "weight": 1.0, "pred": {"1.0": -1000.0}},
               {"response": 0, "weight": 1.0, "pred": {"1.0": 1000.0}}]
    agg = tscore.aggregate_item_loglik(extreme)
    assert agg[0]["testLoglik"] == pytest.approx(-1000.0, rel=1e-6)


def test_sharded_loading_and_run_match_jax(tmp_path):
    """A model file written by the port shards and scores identically in
    both packages, and the reverse."""
    tpath, jpath = str(tmp_path / "t.avro"), str(tmp_path / "j.avro")
    write_model_file(tpath, mk_models(LinearModel))
    jwrite_models(jpath, mk_models(JLinearModel))
    records = _mk_records()
    for path in (tpath, jpath):
        seen = {}
        for k in range(3):
            shard = tscore.read_model_file_sharded(path, shard=k, nshards=3)
            jshard = jscore.read_model_file_sharded(path, shard=k, nshards=3)
            assert set(shard) == set(jshard)
            for key, model in shard.items():
                assert key not in seen
                seen[key] = model
                assert tscore.item_shard(key.split("#")[1], 3) == k
                assert model.coefficients == jshard[key].coefficients
                assert model.intercept == jshard[key].intercept
        assert set(seen) == set(mk_models(LinearModel))
        only1 = tscore.read_model_file_sharded(path, lambda_prefix="1.0#")
        assert set(only1) == {"1.0#itemA", "1.0#itemB"}

        base = tscore.run_item_model_test(
            records, SCHEMA, mk_models(LinearModel),
            str(tmp_path / "pred0.avro"), item_key="itemId",
            model_prefixes=["1.0", "2.0"], device="cpu")
        shd = tscore.run_item_model_test_sharded(
            records, SCHEMA, path, str(tmp_path / "pred1.avro"),
            item_key="itemId", model_prefixes=["1.0", "2.0"], nshards=3,
            device="cpu")
        jshd = jscore.run_item_model_test_sharded(
            records, SCHEMA, path, str(tmp_path / "pred2.avro"),
            item_key="itemId", model_prefixes=["1.0", "2.0"], nshards=3)
        assert [r["pred"] for r in base] == [r["pred"] for r in shd] \
            == [r["pred"] for r in jshd]
        auto = tscore.run_item_model_test_sharded(
            records, SCHEMA, path, str(tmp_path / "pred3.avro"),
            item_key="itemId", nshards=2, device="cpu")
        assert set(auto[0]["pred"]) == {"1.0", "2.0"}
        assert javro.read_records(str(tmp_path / "pred1.avro")) == \
            javro.read_records(str(tmp_path / "pred2.avro"))


# ---------------------------------------------------------------------------
# the slice as a whole: `item` then `itemtest` through both CLIs
# ---------------------------------------------------------------------------

ITEM_SCHEMA = {
    "type": "record", "name": "R", "fields": [
        {"name": "item", "type": "string"},
        {"name": "response", "type": "int"},
        {"name": "features", "type": SCHEMA["fields"][4]["type"]},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"}]}


def write_job(path, **kv):
    with open(path, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in kv.items())
    return str(path)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("nshards", [1, 3])
def test_cli_item_then_itemtest_matches_jax_cli(tmp_path, capsys, nshards):
    rng = np.random.default_rng(1)
    recs = []
    for i in range(240):
        feats = [{"name": f"f{int(j)}", "term": "", "value": float(v)}
                 for j, v in zip(rng.choice(4, 2, replace=False),
                                 rng.normal(size=2))]
        recs.append({"item": f"it{i % 4}", "response": int(rng.integers(0, 2)),
                     "features": feats, "weight": 1.0,
                     "offset": float(rng.normal() * 0.1)})
    data = str(tmp_path / "items.avro")
    tavro.write_records(data, ITEM_SCHEMA, recs)
    pm_map = str(tmp_path / "pm.avro")
    tavro.write_records(pm_map, {
        "type": "record", "name": "KV", "fields": [
            {"name": "key", "type": "string"},
            {"name": "value", "type": "float"}]},
        [{"key": "it1", "value": 0.5}])

    outs = {}
    for tag, main, extra in (("torch", tmain, ["--device", "cpu"]),
                             ("jax", jmain, [])):
        model_out = str(tmp_path / f"{tag}-models")
        job = write_job(tmp_path / f"{tag}-item.job", **{
            "input.paths": data, "item.key": "item",
            "intercept.lambdas": "1", "default.lambdas": "1,4",
            "intercept.default.prior.mean": "-0.2",
            "intercept.prior.mean.map": pm_map,
            "compute.var": "true", "liblinear.epsilon": "1e-6",
            "output.model.path": model_out, "dtype": "float64",
            "native.ingest": "false"})
        assert main(["item", job, *extra]) == 0
        printed = last_json(capsys)
        assert printed["models"] == 8           # 4 items x 1x2 grid
        test_out = str(tmp_path / f"{tag}-itest")
        job2 = write_job(tmp_path / f"{tag}-itemtest.job", **{
            "input.paths": data, "model.path": printed["output"],
            "item.key": "item", "output.base.path": test_out,
            "num.model.shards": nshards})
        assert main(["itemtest", job2, *extra]) == 0
        agg = last_json(capsys)
        outs[tag] = (printed, agg, printed["output"], test_out)

    t_printed, t_agg, t_models, t_out = outs["torch"]
    _jp, j_agg, j_models, j_out = outs["jax"]
    assert t_printed["device"] == "cpu"
    assert t_printed["kernel_launches"] == {"segment_sum_sorted": 0,
                                            "gram_batched": 0,
                                            "head_xv": 0, "head_xtv": 0}
    assert t_agg["kernel_launches"]["segment_sum_sorted"] == 0
    # models: same keys, coefficients to 1e-6, variances to 1e-5
    t_recs = {r["key"]: r for r in tavro.read_records(t_models)}
    j_recs = {r["key"]: r for r in javro.read_records(j_models)}
    assert set(t_recs) == set(j_recs)
    for key, j in j_recs.items():
        for field, rtol in (("model", 1e-6), ("posteriorVar", 1e-5)):
            got = {(f["name"], f["term"]): f["value"]
                   for f in t_recs[key][field]}
            want = {(f["name"], f["term"]): f["value"] for f in j[field]}
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-7)
    # predictions and logliks
    t_pred = tavro.read_records(t_out + "/pred")
    j_pred = javro.read_records(j_out + "/pred")
    assert len(t_pred) == len(j_pred) == 240
    for t, j in zip(t_pred, j_pred):
        assert set(t["pred"]) == set(j["pred"]) == {"1.0:1.0", "1.0:4.0"}
        for k, v in j["pred"].items():
            assert t["pred"][k] == pytest.approx(v, rel=1e-5, abs=1e-6)
    t_ll = tavro.read_records(t_out + "/_loglik")
    assert len(t_ll) == len(j_agg) == 2
    for t, j, printed in zip(t_ll, j_agg, t_agg["loglik"]):
        assert t["key"] == j["key"] == printed["key"]
        assert t["count"] == j["count"] == 240
        assert np.isfinite(t["testLoglik"])
        assert t["testLoglik"] == pytest.approx(j["testLoglik"], rel=1e-6)
    # each package scores the other's model file
    cross = write_job(tmp_path / "cross.job", **{
        "input.paths": data, "model.path": j_models, "item.key": "item",
        "output.base.path": str(tmp_path / "cross-out")})
    assert tmain(["itemtest", cross, "--device", "cpu"]) == 0
    cross_agg = last_json(capsys)["loglik"]
    for c, j in zip(cross_agg, j_agg):
        assert c["testLoglik"] == pytest.approx(j["testLoglik"], rel=1e-12)
    cross2 = write_job(tmp_path / "cross2.job", **{
        "input.paths": data, "model.path": t_models, "item.key": "item",
        "output.base.path": str(tmp_path / "cross2-out")})
    assert jmain(["itemtest", cross2]) == 0
    for c, t in zip(last_json(capsys), t_agg["loglik"]):
        assert c["testLoglik"] == pytest.approx(t["testLoglik"], rel=1e-12)
