"""Small statistics the metric readers share."""

from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least q of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]


def iteration_times(run: dict) -> list[float]:
    """Every iteration's seconds in the window, path after path: each
    path's first iteration counted from the path's start (its prologue
    included), every later one from the previous iteration's end."""
    out = []
    for p in run["paths"]:
        marks = [p["start"]] + p["marks"]
        out.extend(b - a for a, b in zip(marks, marks[1:]))
    return out
