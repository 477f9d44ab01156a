"""iter_ms_p95.streamed (ms): iter_ms_p95 of a streamed cell (layer:
the streaming driver); nothing for an in-memory one."""

from gpubench.stats import iteration_times, nearest_rank


def read(run):
    if run["wire_bytes_per_iter"] is None:
        return None
    return 1e3 * nearest_rank(iteration_times(run), 0.95)
