"""The readers of the program's spans (gpubench/spans.py and the six
metrics on it) on a synthetic record and store: only the spans whose
iteration ended inside the window count, device time is divided by the
window's iterations, and a store with nothing to read, or a program with
no store, gives None. Then a tiny traced run on the CPU reports them from
the program's own store."""

from __future__ import annotations

import os

import pytest

from conftest import ROOT, tiny_root
from gpubench import run as gb_run
from gpubench import spans
from mlease_tpu_torch.utils import profiling
from mlease_tpu_torch.utils.profiling import Span

METRICS = ["loop_ms_per_iter", "head_ms_per_iter", "tail_ms_per_iter",
           "wire_wait_ms_per_iter", "epilogue_ms", "hybrid_s"]
S = 1_000_000_000           # ns a second


def reader(name):
    return gb_run.load_reader(os.path.join(ROOT, "gpubench", "metrics"),
                              name)


def record():
    """Two timed paths of two iterations each, in seconds 10-20."""
    return {"paths": [{"start": 10.0, "marks": [11.0, 12.0], "end": 14.0},
                      {"start": 14.0, "marks": [15.0, 16.0], "end": 20.0}]}


def store():
    """A warm-up path before the window, the window's two paths, a path
    after it; each iteration with its device spans, each run its epilogue;
    two conversions in the build."""
    out: list[Span] = []

    def add(name, start, end, parent=-1, ns=None, n=None, dev=None):
        out.append(Span(name, start, end, parent, 0, 0, ns, n, dev))
        return len(out) - 1

    add("to_hybrid", 1 * S, 3 * S)
    add("to_hybrid", 3 * S, 4 * S)
    for path, (iters, epi) in enumerate([
            ([(6, 7), (7, 8)], (8, 9)),              # warm-up
            ([(10, 11), (11, 12)], (12, 14)),        # in the window
            ([(14, 15), (15, 16)], (16, 20)),        # in the window
            ([(21, 22), (22, 23)], (23, 24))]):      # after it
        for a, b in iters:
            it = add("admm_iteration", a * S, b * S)
            add("head_pass", None, None, it, 3_000_000, 4, "cuda:0")
            add("tail_pass", None, None, it, 1_000_000, 2, "cuda:0")
            add("x/launch", a * S, a * S + 9_000_000, it, 8_000_000, 1,
                "cuda:0")
            add("group1/launch", a * S, a * S + 9_000_000, it, 2_000_000, 1,
                "cuda:0")
            add("x/cg_trip", None, None, it, 5_000_000, 7, "cuda:0")
            if path == 2:
                add("wire_wait", None, None, it, 500_000, 1, "cuda:0")
        a, b = epi
        add("admm_epilogue", a * S, b * S)
    return {"spans": out, "dropped": 0, "clocks": {}}


def test_window_and_division():
    rec, st = record(), store()
    # four iterations in the window, each 3 ms of head, 1 of tail, 8 + 2
    # of launches; the wire stalled twice, 0.5 ms each
    assert reader("head_ms_per_iter")(rec, st) == pytest.approx(3.0)
    assert reader("tail_ms_per_iter")(rec, st) == pytest.approx(1.0)
    assert reader("loop_ms_per_iter")(rec, st) == pytest.approx(10.0)
    assert reader("wire_wait_ms_per_iter")(rec, st) == pytest.approx(0.25)
    # the window's epilogues are 2 s and 4 s: the median of two
    assert reader("epilogue_ms")(rec, st) == pytest.approx(3000.0)
    # the build's conversions, 2 s and 1 s, before the window
    assert reader("hybrid_s")(rec, st) == pytest.approx(3.0)


def test_launch_names_are_matched_by_suffix():
    rec, st = record(), store()
    found = spans.in_window(rec, st["spans"], ("/launch",))
    assert {s.name for s in found} == {"x/launch", "group1/launch"}
    assert len(found) == 8
    assert spans.in_window(rec, st["spans"], ("launch",)) == []


def test_nothing_recorded_gives_none():
    rec = record()
    empty = {"spans": [], "dropped": 0, "clocks": {}}
    for name in METRICS:
        assert reader(name)(rec, empty) is None, name
    # device spans whose iterations all ended outside the window
    st = store()
    outside = {"spans": [s for s in st["spans"]], "dropped": 0,
               "clocks": {}}
    far = {"paths": [{"start": 100.0, "marks": [101.0], "end": 102.0}]}
    for name in METRICS[:4] + ["epilogue_ms"]:
        assert reader(name)(far, outside) is None, name


def test_a_program_without_a_store_gives_none(monkeypatch):
    """The parent of the spans has no profiling.recorded: every reader
    returns None, and none raises."""
    monkeypatch.delattr(profiling, "recorded")
    assert spans.store() is None
    for name in METRICS:
        assert reader(name)(record()) is None, name


@pytest.mark.parametrize("cell", ["ctr12m.inmem", "ctr12m.job"])
def test_a_traced_tiny_run_reports_the_span_metrics(cell, tmp_path):
    """A traced run at TINY_DATA's size on the CPU reads the metrics of
    this cell from the program's own store, each above 0 (the streamed
    cell at this size ships nothing: no wire_wait)."""
    root = tiny_root(tmp_path)
    profiling.reset()
    out = gb_run.run_cell(cell, 2**31 + 5, 0.3, True, root=root,
                          device="cpu", log=lambda s: None)
    got = out["metrics"]
    for name in METRICS:
        if name == "wire_wait_ms_per_iter":
            assert name not in got
            continue
        assert got[name]["value"] > 0, name
    assert got["hybrid_s"]["value"] <= got["build_s"]["value"]
