"""The program's recorded spans, as the per-layer readers of the spans
(gpubench/metrics/*_per_iter.py, epilogue_ms.py, hybrid_s.py) take them:
the store of `mlease_tpu_torch.utils.profiling.recorded()`, on the clock
`run.py` marks its paths with (time.perf_counter, here in nanoseconds).

A program without that store (one older than its spans) gives None, and
so does every reader: the metric is then left out of the line."""

from __future__ import annotations


def store():
    """The program's span store, or None where it keeps none."""
    try:
        from mlease_tpu_torch.utils import profiling
        return profiling.recorded()
    except (ImportError, AttributeError):
        return None


def window_ns(run) -> tuple[float, float]:
    """The window: the first timed path's start to the last path's end."""
    return run["paths"][0]["start"] * 1e9, run["paths"][-1]["end"] * 1e9


def iterations(run) -> int:
    return sum(len(p["marks"]) for p in run["paths"])


def in_window(run, spans, names) -> list:
    """The spans named in `names`, or whose name ends in one of them when
    it starts with "/", whose iteration (the parent span) ended inside the
    window."""
    lo, hi = window_ns(run)

    def named(s):
        return any(s.name.endswith(n) if n.startswith("/") else s.name == n
                   for n in names)

    out = []
    for s in spans:
        if not named(s) or s.parent < 0:
            continue
        end = spans[s.parent].end
        if end is not None and lo <= end <= hi:
            out.append(s)
    return out


def ms_per_iteration(run, st, *names) -> float | None:
    """The device nanoseconds of the named spans in the window over the
    window's iterations, in ms; None where the window holds none."""
    if st is None:
        st = store()
    if st is None:
        return None
    found = in_window(run, st["spans"], names)
    if not found:
        return None
    return sum(s.ns for s in found) / 1e6 / iterations(run)


def host_spans(st, *names) -> list:
    """The host spans of these names that have ended."""
    if st is None:
        st = store()
    if st is None:
        return []
    return [s for s in st["spans"] if s.name in names
            and s.device is None and s.start is not None
            and s.end is not None]
