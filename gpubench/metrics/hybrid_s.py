"""hybrid_s (s): the trainer build's dense-head and sorted-tail
conversion (the spans `to_hybrid`, core/dataset.py), summed over the
conversions that ended before the first timed path: the process's one
build, in memory or group by group streamed. A part of build_s."""

from gpubench.spans import host_spans, window_ns


def read(run, store=None):
    lo, _ = window_ns(run)
    d = [s.end - s.start for s in host_spans(store, "to_hybrid")
         if s.end <= lo]
    return sum(d) / 1e9 if d else None
