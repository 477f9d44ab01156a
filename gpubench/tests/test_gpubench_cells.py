"""BENCHMARK.json against the benchmark's contract, and every cell
resolved to its files by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GB = os.path.join(ROOT, "gpubench")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"][1] == "gpubench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = configs[cell["config"]]
    assert cfg["file"] == f"gpubench/configs/{cell['config']}.json"
    conf = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert conf["name"] == cell["config"] and conf["reduced"] == \
        cfg["reduced"] == []
    traffic = json.load(open(os.path.join(GB, "traffic",
                                          f"{cell['traffic']}.json")))
    assert set(traffic) <= {"why", "job"}
    limits = json.load(open(os.path.join(GB, "limits",
                                         f"{cell['name']}.json")))
    assert limits["z_gap"] > 0
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    from gpubench.run import load_cell
    c = load_cell(ROOT, cell["name"])
    reported = {m["name"] for m in c["end_to_end"]}
    assert {"setup_s", "rows_per_s"} <= reported
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["end_to_end"] +
                              BENCH["per_layer"]])
def test_metric_has_a_reader(metric):
    from gpubench.run import load_reader
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(load_reader(os.path.join(GB, "metrics"),
                                metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_names_unique_and_valid():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
