"""iter_ms_p95 (ms): the 95th percentile, by nearest rank, of every
iteration's time in the window on the harness's clock (a path's first
iteration from the path's start)."""

from gpubench.stats import iteration_times, nearest_rank


def read(run):
    return 1e3 * nearest_rank(iteration_times(run), 0.95)
