"""The port's spans and its device clock on the CPU (utils/profiling.py,
ops/device_loop.py::DeviceClock): what run() of the in-memory and of the
streaming trainer records, the data passes' head and K1 spans, the
store's bound, and the profile.dir trace's loop track. On the CPU the
clock's stamps read the host clock around the eager branches, under the
same names as on the card."""

import collections
import json
import time

import numpy as np
import pytest
import torch

from mlease_tpu_torch.core.dataset import BlockedData, split_blocks, to_hybrid
from mlease_tpu_torch.core.vocab import FeatureVocab
from mlease_tpu_torch.ops import tron_multi
from mlease_tpu_torch.ops.device_loop import DeviceClock, DeviceLoop
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
from mlease_tpu_torch.utils import profiling

NF = 200
ITERS = 3


def blocked_data(seed, B=4, R=300, nnz=6):
    rng = np.random.default_rng(seed)
    n = NF + 1
    cols = (rng.zipf(1.3, size=(B, R, nnz)) - 1) % NF
    indices = np.concatenate([cols, np.full((B, R, 1), NF)],
                             axis=2).astype(np.int32)
    values = np.concatenate([rng.normal(size=(B, R, nnz)) * 0.5,
                             np.ones((B, R, 1))], axis=2)
    w = rng.normal(size=n) * 0.3
    p = 1.0 / (1.0 + np.exp(-np.einsum("brk,brk->br", values, w[indices])))
    y = np.where(rng.random((B, R)) < p, 1.0, -1.0)
    present = np.zeros((B, n), dtype=bool)
    for b in range(B):
        present[b, np.unique(indices[b])] = True
    return BlockedData(indices=indices, values=values, y=y,
                       weight=np.ones((B, R)), offset=np.zeros((B, R)),
                       present=present, nrows=np.full(B, R, np.int32),
                       nblocks=B, dim=n)


def vocab():
    return FeatureVocab.from_names(f"f{i}" for i in range(NF))


def config(head=16, **kw):
    return AdmmConfig(lambdas=[1.0, 10.0], num_iters=ITERS, head_size=head,
                      dtype=torch.float32, epsilon=0.0, **kw)


def trainer(kind, head=16):
    data = blocked_data(7)
    if kind == "admm":
        return AdmmTrainer(data, vocab(), config(head), device="cpu")
    return StreamingAdmmTrainer(split_blocks(data, 2), vocab(), config(head),
                                device="cpu")


ITERATION = {"admm": "admm_iteration", "stream": "stream_iteration"}
EPILOGUE = {"admm": "admm_epilogue", "stream": "stream_epilogue"}


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def spans(name=None):
    got = profiling.recorded()["spans"]
    return [s for s in got if name is None or s.name == name]


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_one_span_an_iteration_and_one_epilogue_inside_the_call(kind):
    tr = trainer(kind)
    profiling.reset()
    t0 = time.perf_counter_ns()
    res = tr.run()
    t1 = time.perf_counter_ns()
    its = spans(ITERATION[kind])
    epi = spans(EPILOGUE[kind])
    assert [s.iteration for s in its] == list(range(1, res.iterations + 1))
    assert len(epi) == 1
    assert len({s.run for s in its + epi}) == 1
    for s in its + epi:
        assert t0 <= s.start <= s.end <= t1
    assert epi[0].start >= its[-1].end
    # every device span is a child of its iteration, on the host's clock
    all_spans = spans()
    for s in all_spans:
        if s.device is not None:
            parent = all_spans[s.parent]
            assert parent.name == ITERATION[kind]
            assert (s.run, s.iteration) == (parent.run, parent.iteration)
            assert s.device == "cpu" and s.executions > 0 and s.ns >= 0
    assert profiling.recorded()["clocks"]["cpu"] == {"offset_ns": 0,
                                                     "error_ns": 0}


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_a_to_hybrid_span_per_conversion(kind):
    data = blocked_data(8)
    to_hybrid(data, 8)
    to_hybrid(data, 0)
    assert len(spans("to_hybrid")) == 2
    profiling.reset()
    trainer(kind)
    groups = 1 if kind == "admm" else 2
    assert len(spans("to_hybrid")) == groups


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_branch_executions_in_the_store_equal_the_loops_counts(kind):
    tr = trainer(kind)
    tr.run()
    tr.run()
    by_loop = collections.defaultdict(collections.Counter)
    launches = collections.Counter()
    ns = collections.Counter()
    for s in spans():
        if s.device is None:
            continue
        loop, _, branch = s.name.partition("/")
        if branch == "launch":
            launches[loop] += s.executions
            ns[loop] += s.ns
        elif branch:
            by_loop[loop][branch] += s.executions
    assert set(by_loop) == ({"x"} if kind == "admm" else {"group0",
                                                          "group1"})
    for name, lp in tr._loops.items():
        counts = lp.loop.counts()
        key = "x" if kind == "admm" else f"group{name}"
        assert dict(by_loop[key]) == {
            b: n for b, n in counts["branch_executions"].items() if n}
        # one launch an iteration; the branches inside the launch
        assert launches[key] == counts["loop_launches"] == 2 * ITERS
        assert ns[key] == counts["loop_ns"]
        assert sum(counts["branch_ns"].values()) <= counts["loop_ns"]


@pytest.mark.parametrize("head", [0, 16], ids=["head-less", "head"])
def test_head_and_tail_spans_in_a_run_exactly_as_the_problem_has_them(head):
    tr = trainer("admm", head)
    tr.run()
    got = {s.name for s in spans()}
    assert ("head_pass" in got) == (tr.prob.head_x is not None)
    has_tail = tr.prob.tail_cols is not None or tr.prob.csc_cols is not None
    assert ("tail_pass" in got) == has_tail


def pass_runs(prob):
    """Head and tail slots' executions over the three data passes."""
    clock = DeviceClock("cpu", ("head_pass", "tail_pass"))
    prob = tron_multi.lanes_major(prob)
    L, n = prob.prior_mean.shape
    V = torch.ones((L, n), dtype=prob.prior_mean.dtype)
    D = torch.ones((L, prob.y.shape[0]), dtype=prob.prior_mean.dtype)
    with clock.active():
        tron_multi._xv_lm(prob, V)
        tron_multi._xtv_lm(prob, D)
        tron_multi._xtv_and_sqdiag_lm(prob, D, D)
    return (int(clock.table[clock.rows["head_pass"], 2]),
            int(clock.table[clock.rows["tail_pass"], 2]))


def test_head_and_tail_spans_of_each_pass():
    """A head: one head span a pass; sorted tails: one K1 span each in the
    Xv pass, one each in the two X'v passes; the ELL's column copy one
    more in the X'v passes; a part the problem lacks, none."""
    prob = trainer("admm", 16).prob
    assert prob.head_x is not None and prob.csc_cols is None
    assert pass_runs(prob) == (3, 3)
    no_tail = prob._replace(tail_cols=None, tail_rows=None, tail_vals=None,
                            tail_c_cols=None, tail_c_rows=None,
                            tail_c_vals=None)
    assert pass_runs(no_tail) == (3, 0)
    headless = trainer("admm", 0).prob
    assert headless.head_x is None and headless.csc_cols is not None
    assert pass_runs(headless) == (0, 2)


def test_no_clock_no_stamps():
    """Outside a trainer's run no clock is active: the passes and a loop
    without a clock stamp nothing into any trainer's slots."""
    tr = trainer("admm", 16)
    tr.run()
    before = tr.clock.table.clone()
    tron_multi.xv(tr.prob, torch.ones_like(tr.prob.prior_mean))
    assert torch.equal(tr.clock.table, before)
    profiling.reset()
    phase = torch.zeros((), dtype=torch.int32)
    seen = []
    loop = DeviceLoop([(1, "once", lambda: (seen.append(1),
                                            phase.fill_(0)))], phase, [])
    phase.fill_(1)
    loop.run()
    counts = loop.counts()
    assert seen == [1] and counts["branch_executions"] == {"once": 1}
    assert counts["loop_launches"] == 1
    assert counts["branch_ns"]["once"] <= counts["loop_ns"]
    assert spans() == []


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_a_second_run_gives_the_same_bits_under_a_new_run_id(kind):
    tr = trainer(kind)
    first = tr.run()
    second = tr.run()
    assert np.array_equal(first.z, second.z)
    assert np.array_equal(first.u, second.u)
    runs = [sorted({s.run for s in spans(ITERATION[kind])
                    if s.iteration == i}) for i in range(1, ITERS + 1)]
    assert all(len(r) == 2 for r in runs)
    r1, r2 = runs[0]
    assert r1 != r2
    for s in spans():
        if s.device is not None:
            assert s.run in (r1, r2)


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.span("a", run=5, iteration=2) as a:
        with profiling.span("b"):
            pass
        with profiling.span("c"):
            profiling.record("d", ns=7, executions=1, device="cpu")
            profiling.record("e", ns=7, executions=1, device="cpu")
    got = profiling.recorded()
    assert [s.name for s in got["spans"]] == ["a", "b", "c"]
    assert got["dropped"] == 2
    assert got["spans"][1].parent == a == 0
    assert (got["spans"][2].run, got["spans"][2].iteration) == (5, 2)
    with profiling.span("f") as f:
        profiling.record("g", ns=1, executions=1, device="cpu")
    assert f == -1 and profiling.recorded()["dropped"] == 4
    profiling.reset()
    assert profiling.recorded() == {"spans": [], "dropped": 0, "clocks": {}}


def test_the_offset_keeps_the_tightest_bounds():
    profiling.note_offset("cuda:0", 1_000, 400)
    profiling.note_offset("cuda:0", 900, 300)
    profiling.note_offset("cuda:0", 950, 600)
    profiling.note_offset("cuda:0", None, None)
    with profiling.span("it"):
        profiling.record("x/launch", ns=5, executions=1, device="cuda:0",
                         start=10, end=15)
    got = profiling.recorded()
    assert got["clocks"]["cuda:0"] == {"offset_ns": 900, "error_ns": 300}
    launch = got["spans"][1]
    assert (launch.start, launch.end) == (910, 915)


def test_a_profiler_sees_the_host_spans():
    from torch.profiler import ProfilerActivity, profile

    tr = trainer("admm", 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run()
    names = {ev.name for ev in prof.events()}
    assert {"admm_iteration", "admm_epilogue"} <= names
    # and not without one
    tr.run()
    assert len(spans("admm_epilogue")) == 2


def test_profile_dir_trace_holds_the_loop_launches(tmp_path):
    """trace(dir) adds each loop launch of the region to the Chrome trace,
    on the trace's clock, inside its iteration's span."""
    tr = trainer("stream", 16)
    with profiling.trace(str(tmp_path)):
        res = tr.run()
    (path,) = tmp_path.glob("trace-*.json")
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    loops = [e for e in events if e.get("cat") == "device_loop"]
    iters = [e for e in events if e.get("name") == "stream_iteration"
             and e.get("ph") == "X"]
    assert len(iters) == res.iterations
    assert len(loops) == 2 * res.iterations
    assert {e["name"] for e in loops} == {"group0/launch", "group1/launch"}
    slack = 100.0       # us: the anchor's and the trace's rounding
    for e in loops:
        it = [i for i in iters if i["ts"] - slack <= e["ts"]
              and e["ts"] + e["dur"] <= i["ts"] + i["dur"] + slack]
        assert len(it) == 1, e
        assert e["args"]["iteration"] == iters.index(it[0]) + 1
