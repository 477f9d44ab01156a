"""epilogue_ms (ms): run()'s epilogue after its last iteration (the span
`admm_epilogue` or `stream_epilogue`: z and u to the host,
LinearModel.from_dense for each lambda and the best model), the median
over the window's paths."""

from gpubench.spans import host_spans, window_ns


def read(run, store=None):
    lo, hi = window_ns(run)
    d = sorted(s.end - s.start
               for s in host_spans(store, "admm_epilogue", "stream_epilogue")
               if lo <= s.end <= hi)
    if not d:
        return None
    m = len(d) // 2
    return (d[m] if len(d) % 2 else 0.5 * (d[m - 1] + d[m])) / 1e6
