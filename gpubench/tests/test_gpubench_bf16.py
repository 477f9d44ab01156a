"""The cell ctr12m.bf16 (ctr-12m with dtype = bfloat16 on the inmem
traffic) and the readers of the bf16 solve's spans (head_gemm_ms_per_iter,
head_gemm_roofline, tail_bf16_roofline): the cell resolves, runs on the
CPU at TINY_DATA's size and is correct when sound, and not correct with a
fault planted underneath the harness; the readers are checked against hand
counts, and give None where there is nothing to read.

The cell's limit is wide (PERF.md section 2): ctr-12m's lambda 1 lane
freezes near the inner tolerance in the float64 reference, and a bf16 z's
rounding flips that freeze on some seeds. So the faults planted here are
those a limit of that width can see."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT
from gpubench import roofline
from gpubench import run as gb_run
from mlease_tpu_torch.utils import profiling
from mlease_tpu_torch.utils.profiling import Span

CELL = "ctr12m.bf16"
CONFIG = "ctr-12m-bf16"
SEED = 2**31 + 91
READERS = ["head_gemm_ms_per_iter", "head_gemm_roofline",
           "tail_bf16_roofline"]
S = 1_000_000_000           # ns a second
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
LIMIT = json.load(open(os.path.join(ROOT, "gpubench", "limits",
                                    f"{CELL}.json")))["z_gap"]


def reader(name):
    return gb_run.load_reader(os.path.join(ROOT, "gpubench", "metrics"),
                              name)


def config(name):
    with open(os.path.join(ROOT, "gpubench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _run(root, traced=False, seconds=0.5):
    return gb_run.run_cell(CELL, SEED, seconds, traced, root=root,
                           device="cpu", log=lambda s: None)


def test_the_configuration_is_ctr12m_in_bfloat16():
    mine, twin = config(CONFIG), config("ctr-12m")
    assert mine["name"] == CONFIG and mine["reduced"] == []
    assert mine["data"] == twin["data"]
    assert mine["job"] == dict(twin["job"], dtype="bfloat16")
    assert mine["assumed"][:len(twin["assumed"])] == twin["assumed"]


def test_the_cell_resolves_to_a_bf16_job_on_inmem_traffic(tiny):
    cell, = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (CONFIG, "inmem", 1)
    c = gb_run.load_cell(tiny, CELL)
    twin = gb_run.load_cell(tiny, "ctr12m.inmem")
    assert c["job"] == dict(twin["job"], dtype="bfloat16")
    assert "streaming.groups" not in c["job"]
    assert [m["name"] for m in c["end_to_end"]] == [
        "rows_per_s", "host_rss_peak_gb", "setup_s"]
    assert [m["name"] for m in BENCH["per_layer"][-3:]] == READERS
    assert set(READERS) <= {m["name"] for m in c["per_layer"]}
    # the readers are reported in this cell alone
    for other in ("ctr12m.inmem", "ctr12m.job", "ctr25m.job"):
        names = {m["name"] for m in gb_run.load_cell(tiny, other)
                 ["per_layer"]}
        assert not names & set(READERS), other


def test_sound_run_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"], out["compared"]
    assert out["compared"]["z_gap"]["limit"] == LIMIT
    assert out["failed"] == 0 and out["attempted"] > 0


def _state_unchanged(monkeypatch):
    """The x-update takes its inputs and returns them unsolved."""
    from mlease_tpu_torch.train import admm

    monkeypatch.setattr(admm._SolveLoop, "solve",
                        lambda self, z, u, rho, eps:
                        self.set_inputs(z, u, rho, eps))


def _half_the_blocks(monkeypatch):
    """Half of each solve's blocks left out: the consensus mean is taken
    over the rest (their x-updates stand in for the dropped ones)."""
    from mlease_tpu_torch.train import admm

    x = admm._SolveLoop.x

    def half(self):
        out = x(self).clone()
        B = out.shape[1]
        out[:, B - B // 2:] = out[:, :B // 2]
        return out
    monkeypatch.setattr(admm._SolveLoop, "x", half)


def _answer_altered(monkeypatch):
    """The consensus z of the first lambda off by ten times the cell's
    limit where it is made."""
    from mlease_tpu_torch.ops import admm_math

    z_update = admm_math.z_update_l2

    def altered(*args, **kw):
        z = z_update(*args, **kw).clone()
        z[0] *= 1 + 10 * LIMIT
        return z
    monkeypatch.setattr(admm_math, "z_update_l2", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_blocks,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_blocks",
                              "answer_altered"])
def test_broken_path_is_not_correct(fault, tiny, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny)
    assert not out["correct"], out["compared"]


def test_a_traced_tiny_run_reads_the_head_gemm_span(tiny):
    """On the CPU every head pass takes torch's products: head_gemm_ms_per_
    iter reads above 0; the two shares read None off a card."""
    profiling.reset()
    out = _run(tiny, traced=True, seconds=0.3)
    assert out["failed"] == 0 and out["attempted"] > 0
    got = out["metrics"]
    assert got["head_gemm_ms_per_iter"]["value"] > 0
    assert "head_gemm_roofline" not in got
    assert "tail_bf16_roofline" not in got


# -- the readers on a synthetic record and store ------------------------

def record():
    """One timed path of two iterations over two solves (a streamed
    record's shape; the in-memory cell has one), in seconds 10-13."""
    stats = [{"newton_trips": 3, "cg_trips": 9},
             {"newton_trips": 2, "cg_trips": 6}]
    return {"paths": [{"start": 10.0, "marks": [11.0, 12.0], "end": 13.0,
                       "solver_stats": stats,
                       "trip_log": [[[2, 5], [1, 4]], [[1, 3], [1, 3]]]}],
            "shapes": [roofline.ProblemShape(R=1000, N=50, T=300, H=8, L=3,
                                             head_itemsize=2),
                       roofline.ProblemShape(R=500, N=50, T=100, H=8, L=3,
                                             head_itemsize=2)]}


def store(device="cuda:0", dropped=0, names=("head_pass", "head_gemm",
                                             "tail_pass", "tail_bf16")):
    """An iteration before the window, two in it, one after; each with
    its head and tail spans: head_pass 3 ms, head_gemm 2 ms, tail_pass
    1.5 ms, tail_bf16 1 ms."""
    ns = {"head_pass": 3_000_000, "head_gemm": 2_000_000,
          "tail_pass": 1_500_000, "tail_bf16": 1_000_000}
    out: list[Span] = []
    for a in (5, 10, 11, 20):
        out.append(Span("admm_iteration", a * S, (a + 1) * S, -1, 0, 0))
        it = len(out) - 1
        for name in names:
            out.append(Span(name, None, None, it, 0, 0, ns[name], 40,
                            device))
    return {"spans": out, "dropped": dropped, "clocks": {}}


def test_head_gemm_ms_per_iter_by_hand():
    # the two iterations in the window, 2 ms each, over 2 iterations
    assert reader("head_gemm_ms_per_iter")(record(), store()) == \
        pytest.approx(2.0)


def test_head_gemm_roofline_by_hand():
    # passes: 2 (2 + 5) + 2 (1 + 3) of solve 0 and 2 (1 + 4) + 2 (1 + 3)
    # of solve 1 (trip_log is per iteration, then per solve), each reading
    # R H 2 bytes of head: 1,000 x 8 x 2 and 500 x 8 x 2; head_gemm's
    # 2 x 2 ms
    head = (14 + 8) * 16_000 + (10 + 8) * 8_000
    want = 100 * head / 3.35e12 / 4e-3
    assert reader("head_gemm_roofline")(record(), store()) == \
        pytest.approx(want)


def test_tail_bf16_roofline_by_hand():
    # the same passes, each reading T (2 + 8) bytes of tail: 300 x 10 and
    # 100 x 10; tail_bf16's 2 x 1 ms
    tail = (14 + 8) * 3_000 + (10 + 8) * 1_000
    want = 100 * tail / 3.35e12 / 2e-3
    assert reader("tail_bf16_roofline")(record(), store()) == \
        pytest.approx(want)


def test_without_the_trip_log_the_stats_count():
    rec = record()
    rec["paths"][0]["trip_log"] = []
    rec["shapes"] = rec["shapes"][:1]
    # 2 (3 + 9) + 2 (2 + 6) passes of solve 0
    assert reader("tail_bf16_roofline")(rec, store()) == pytest.approx(
        100 * 40 * 3_000 / 3.35e12 / 2e-3)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(name, monkeypatch):
    """A float32 solve's store (head_pass and tail_pass alone), an empty
    store, a store that dropped spans, spans outside the window and, for
    the shares, spans off a card or an untraced record; and a program
    with no store (the parent of the spans)."""
    rec = record()
    f32 = store(names=("head_pass", "tail_pass"))
    assert reader(name)(rec, f32) is None
    assert reader(name)(rec, {"spans": [], "dropped": 0,
                              "clocks": {}}) is None
    far = dict(rec, paths=[dict(rec["paths"][0], start=100.0,
                                marks=[101.0], end=102.0)])
    assert reader(name)(far, store()) is None
    if name.endswith("_roofline"):
        assert reader(name)(rec, store(dropped=1)) is None
        assert reader(name)(rec, store(device="cpu")) is None
        assert reader(name)(dict(rec, shapes=None), store()) is None
    monkeypatch.delattr(profiling, "recorded")
    assert reader(name)(rec) is None
