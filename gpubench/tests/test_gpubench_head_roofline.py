"""head_roofline's reader on a synthetic record and store: the head's
bytes of the window's passes (two a trip, from the trip counts) over the
HBM rate, against the window's head_pass time; None where there is
nothing to read on a card's clock."""

from __future__ import annotations

import os

import pytest

from conftest import ROOT
from gpubench import roofline
from gpubench import run as gb_run
from mlease_tpu_torch.utils import profiling
from mlease_tpu_torch.utils.profiling import Span

S = 1_000_000_000


def reader():
    return gb_run.load_reader(os.path.join(ROOT, "gpubench", "metrics"),
                              "head_roofline")


def record():
    """One timed path of two streamed iterations over two groups, and the
    shapes of the two groups."""
    stats = [{"newton_trips": 3, "cg_trips": 9},
             {"newton_trips": 2, "cg_trips": 6}]
    return {"paths": [{"start": 10.0, "marks": [11.0, 12.0], "end": 13.0,
                       "solver_stats": stats,
                       "trip_log": [[[2, 5], [1, 4]], [[1, 3], [1, 3]]]}],
            "shapes": [roofline.ProblemShape(R=1000, N=50, T=10, H=8, L=3,
                                             head_itemsize=2),
                       roofline.ProblemShape(R=500, N=50, T=10, H=8, L=3,
                                             head_itemsize=2)]}


def store(device="cuda:0", dropped=0):
    out: list[Span] = []
    for a in (5, 10, 11, 20):           # a warm-up, the window, after it
        out.append(Span("admm_iteration", a * S, (a + 1) * S, -1, 0, 0))
        out.append(Span("head_pass", None, None, len(out) - 1, 0, 0,
                        2_000_000, 40, device))
    return {"spans": out, "dropped": dropped, "clocks": {}}


def test_the_share_by_hand():
    # passes: 2 (2 + 5) + 2 (1 + 4) and 2 (1 + 3) + 2 (1 + 3): 14 and 8 of
    # group 0's 1,000 x 8 x 2 bytes, 10 and 8 of group 1's 500 x 8 x 2
    head = (14 + 8) * 16_000 + (10 + 8) * 8_000
    want = 100 * head / 3.35e12 / (2 * 2e-3)
    assert reader()(record(), store()) == pytest.approx(want)


def test_one_problem_without_a_trip_log_reads_the_stats():
    rec = record()
    rec["paths"][0]["trip_log"] = []
    rec["shapes"] = rec["shapes"][:1]
    head = (2 * 12 + 2 * 8) * 16_000
    assert reader()(rec, store()) == pytest.approx(
        100 * head / 3.35e12 / 4e-3)


def test_nothing_to_read_on_a_card_gives_none(monkeypatch):
    rec = record()
    assert reader()(rec, store(dropped=1)) is None
    assert reader()(rec, store(device="cpu")) is None
    assert reader()(rec, {"spans": [], "dropped": 0, "clocks": {}}) is None
    assert reader()(dict(rec, shapes=None), store()) is None
    monkeypatch.delattr(profiling, "recorded")
    assert reader()(rec) is None
