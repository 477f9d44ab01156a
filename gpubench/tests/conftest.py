"""Shared fixtures of the benchmark's tests: a checkout-like root holding
a tiny copy of a cell (the real cells' job keys, small shapes), run on
the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_DATA = {"rows": 2400, "blocks": 4, "n_features": 3000, "nnz": 12,
             "zipf_a": 1.3, "value_std": 0.5, "w_std": 0.3,
             "intercept_weight": -1.5, "test_rows": 300}


def tiny_root(tmp_path, job_overrides=None, limit=None) -> str:
    """A root with BENCHMARK.json and gpubench/ whose cells are the real
    ones at TINY_DATA's size (head 16, 4 iterations)."""
    root = tmp_path / "root"
    (root / "gpubench").mkdir(parents=True)
    for sub in ("metrics", "traffic"):
        shutil.copytree(os.path.join(ROOT, "gpubench", sub),
                        root / "gpubench" / sub)
    (root / "gpubench" / "configs").mkdir()
    (root / "gpubench" / "limits").mkdir()
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        cfg["data"] = dict(TINY_DATA)
        cfg["job"].update({"num.blocks": "4", "head.size": "16",
                           "num.iters": "4"})
        if "streaming.groups" in cfg["job"]:
            cfg["job"]["streaming.groups"] = "2"
        cfg["job"].update(job_overrides or {})
        json.dump(cfg, open(root / "gpubench" / "configs" /
                            f"{c['name']}.json", "w"))
    for w in bench["workloads"]:
        lim = json.load(open(os.path.join(ROOT, "gpubench", "limits",
                                          f"{w['name']}.json")))
        if limit is not None:
            lim = {k: limit for k in lim}
        json.dump(lim, open(root / "gpubench" / "limits" /
                            f"{w['name']}.json", "w"))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return str(root)


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
