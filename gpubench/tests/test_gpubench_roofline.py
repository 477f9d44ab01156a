"""The yardstick's byte and pass counts against a hand count."""

from __future__ import annotations

import pytest

from gpubench import roofline


def test_k1_bytes_by_hand():
    # 1,000 entries (4-byte value + two 4-byte ids), 3 lanes gathering
    # from 400 rows (all touchable: 400 < 1,000), 50 segments out
    assert roofline.k1_bytes(T=1000, S=50, rows=400, L=3) == \
        1000 * 12 + 3 * 400 * 4 + 3 * 50 * 4
    # fewer entries than rows: at most T operand entries a lane
    assert roofline.k1_bytes(T=10, S=5, rows=400, L=2) == \
        10 * 12 + 2 * 10 * 4 + 2 * 5 * 4


def test_pass_and_step_bytes_by_hand():
    p = roofline.ProblemShape(R=100, N=40, T=30, H=8, L=3,
                              head_itemsize=2)
    head = 100 * 8 * 2
    tail = 30 * (4 + 4 + 4)
    rows = 3 * 100 * 4
    vecs = 100 * 3 * 4 + 40 * 3 * 4
    assert roofline.pass_bytes(p) == head + tail + rows + vecs
    assert roofline.passes(3, 9) == 24
    # two problems; the wire is the larger term only when it outweighs
    trips = [(3, 9), (2, 6)]
    hbm = (24 + 16) * roofline.pass_bytes(p)
    assert roofline.step_least_s([p, p], trips) == pytest.approx(
        hbm / 3.35e12)
    assert roofline.step_least_s([p, p], trips, wire_bytes=10**9) == \
        pytest.approx(10**9 / 64e9)
