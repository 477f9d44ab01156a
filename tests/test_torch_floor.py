"""The port's streaming floor accounting (mlease_tpu_torch/utils/floor.py)
against mlease_tpu.utils.floor, on the same groups (each package's
streaming trainer over the same packed blocks), the same trip log and the
same table (platform "cpu"): the same dict, key for key, floats to 1e-12.
Then what is the port's own: a table of another platform or card is
refused with the reason, the table nearest in element count is chosen, and
a streamed train job logs the decomposition line.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JTrainer
from mlease_tpu.utils import floor as jfloor
from mlease_tpu.utils.config import JobConfig
from mlease_tpu_torch.train.admm import AdmmConfig
from mlease_tpu_torch.train.pipeline import \
    run_regression_pipeline as torch_pipeline
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
from mlease_tpu_torch.utils import floor as tfloor

from test_admm import synth_rows
from test_torch_pipeline import job

torch.set_num_threads(1)


def table(platform="cpu", chip="cpu", blocks=2, rows=64, head=4, tail=200,
          features=300):
    return {"chip": chip, "platform": platform, "layout": "flat-blocks",
            "shape": {"features": features, "blocks": blocks, "rows": rows,
                      "nnz": 6, "lambdas": 2, "head": head,
                      "tail_nnz_per_block": tail, "ell_k": 0},
            "floors_ms": {"xv": 0.31, "xtv": 0.42, "fused_xtv_diag": 0.57,
                          "hv": 0.83, "fun_grad_diag": 1.09},
            "null_loop_ms": 0.01, "loop_trips": 50}


def write(path, tab):
    with open(path, "w") as f:
        json.dump(tab, f)
    return str(path)


def groups_of(seed=3, split=(2, 2), n_rows=400):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    nb = sum(split)
    blocks = [rows[i::nb] for i in range(nb)]
    out, lo = [], 0
    for k in split:
        out.append(pack_blocks(blocks[lo:lo + k], vocab))
        lo += k
    return out, vocab


def assert_same_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
        elif k == "per_group":
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert list(a) == list(b)
                for f in b:
                    assert a[f] == pytest.approx(b[f], rel=0, abs=1e-12)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("wire,bw", [("compact", 7.5e9), ("dense", 7.5e9),
                                     ("compact", None)])
def test_streaming_floor_matches_jax(tmp_path, wire, bw):
    groups, vocab = groups_of()
    base = dict(lambdas=[1.0, 10.0], num_iters=2, head_size=4)
    jtr = JTrainer(groups, vocab, JConfig(dtype=jnp.float64, **base),
                   compact_wire=(wire == "compact"))
    ttr = StreamingAdmmTrainer(groups, vocab,
                               AdmmConfig(dtype=torch.float64, **base),
                               device="cpu",
                               compact_wire=(wire == "compact"))
    assert len(ttr.groups) == len(jtr.groups) == 2
    L = len(base["lambdas"])
    for tg, jg in zip(ttr.groups, jtr.groups):
        assert tfloor.group_elems(tg, L) == jfloor.group_elems(jg, L)
    path = write(tmp_path / "floors.json", table())
    tab = json.load(open(path))
    assert tfloor.table_elems(tab) == jfloor.table_elems(tab)
    rng = np.random.default_rng(5)
    trip_log = [rng.integers(1, 9, size=(2, 2)) for _ in range(3)]
    wire_bytes = ttr.stream_wire_bytes()
    got = tfloor.streaming_floor(ttr.groups, trip_log, wire_bytes, 0.0123,
                                 bw, L, path, device="cpu")
    want = jfloor.streaming_floor(jtr.groups, trip_log, wire_bytes, 0.0123,
                                  bw, L, path)
    assert got["util"] is not None and got["source"].startswith(
        "composed from probe table @ cpu")
    assert_same_dict(got, want)
    # no iterations: the same reason on both sides
    assert tfloor.streaming_floor(ttr.groups, [], wire_bytes, 0.01, bw, L,
                                  path, device="cpu") == \
        jfloor.streaming_floor(jtr.groups, [], wire_bytes, 0.01, bw, L, path)


def test_other_platform_or_card_is_refused(tmp_path, monkeypatch):
    monkeypatch.delenv("BENCH_FLOORS", raising=False)
    card = "NVIDIA H100 80GB HBM3"
    path = write(tmp_path / "cuda.json", table("cuda", card))
    tab, why = tfloor.load_floor_table(path, device="cpu")
    assert tab is None and why == ("pass_floors table measured on cuda, "
                                   "running on cpu")
    out = tfloor.streaming_floor(groups_of()[0], [np.ones((2, 2))], 1, 0.1,
                                 None, 2, path, device="cpu")
    assert out == {"floor_iter_s": None, "util": None, "source": why}
    # on a card: the platform and the card's name must both match
    assert tfloor._refusal(table("cuda", card), "cuda", card) is None
    assert tfloor._refusal(table("cuda", "NVIDIA A100-SXM4-80GB"), "cuda",
                           card) == ("pass_floors table measured on NVIDIA "
                                     "A100-SXM4-80GB, running on " + card)
    assert "measured on tpu" in tfloor._refusal(table("tpu", "TPU v5 lite"),
                                                "cuda", card)
    # the repo's tables: the JAX package's are the TPU's, the port's the
    # card's; none applies to the CPU, and the reason names each file
    tab, why = tfloor.load_floor_table(device="cpu")
    assert tab is None and why.startswith(
        "no platform-matching torch_pass_floors*.json")
    assert "running on cpu" in why
    assert tfloor.measure_put_bandwidth(device="cpu") is None


def test_nearest_element_count_table_is_chosen(tmp_path, monkeypatch):
    monkeypatch.delenv("BENCH_FLOORS", raising=False)
    monkeypatch.setattr(tfloor, "TOOLS_DIR", str(tmp_path))
    small = table(rows=64, tail=100)
    big = table(rows=100_000, tail=900_000, blocks=4)
    write(tmp_path / "torch_pass_floors.json", small)
    write(tmp_path / "torch_pass_floors_big.json", big)
    write(tmp_path / "torch_pass_floors_cuda.json", table("cuda", "x"))
    write(tmp_path / "pass_floors.json", table(rows=10**9))  # not the glob
    for target, want in ((tfloor.table_elems(small) * 2, small),
                         (tfloor.table_elems(big) // 3, big),
                         (None, small)):
        tab, why = tfloor.load_floor_table(target_elems=target, device="cpu")
        assert why is None and tab == want, target
    monkeypatch.setenv("BENCH_FLOORS", str(tmp_path / "torch_pass_floors"
                                                      "_big.json"))
    assert tfloor.load_floor_table(target_elems=1, device="cpu")[0] == big


def test_streamed_job_logs_the_decomposition(tmp_path, caplog):
    """A streamed train job logs `streaming pass-floor decomposition:`
    with the reason in "source" when no table applies (on the CPU: the
    repo's tables are the card's); a floor table of the CPU given through
    BENCH_FLOORS gives a numeric util."""
    props = job(str(tmp_path / "out"), **{"streaming.groups": "2",
                                          "num.iters": "2"})
    for env, numeric in ((None, False), (table(blocks=2, rows=200), True)):
        os.environ.pop("BENCH_FLOORS", None)
        if env is not None:
            os.environ["BENCH_FLOORS"] = write(tmp_path / "t.json", env)
        try:
            caplog.clear()
            with caplog.at_level(logging.INFO,
                                 logger="mlease_tpu_torch.train.pipeline"):
                torch_pipeline(JobConfig(props), device="cpu")
        finally:
            os.environ.pop("BENCH_FLOORS", None)
        lines = [r.getMessage() for r in caplog.records
                 if "pass-floor decomposition" in r.getMessage()]
        assert len(lines) == 1, lines
        sf = json.loads(lines[0].split("decomposition: ", 1)[1])
        if numeric:
            assert sf["util"] > 0 and sf["bw_gbps"] is None
            assert sf["source"].startswith("composed from probe table @ cpu")
        else:
            assert sf["util"] is None
            assert "running on cpu" in sf["source"]
