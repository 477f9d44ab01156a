"""cg_trips_per_iter (trips): the x-update's CG trips over the window's
iterations, from the program's AdmmResult.solver_stats (the lock-step
trips of the solve; a streamed iteration sums its groups')."""


def read(run):
    stats = [s for p in run["paths"] for s in p["solver_stats"]]
    if not stats:
        return None
    return sum(s["cg_trips"] for s in stats) / len(stats)
