"""step_mfu (%): the least time of the window's iterations' work over
their measured time. The work is counted from the cell's shapes
(gpubench/roofline.py): each solve's data passes, two a Newton or CG trip
(the program's trip counters), each reading the solve's bytes once, and
a streamed iteration's wire bytes. The least time is bound by bytes (HBM
at 3.35 TB/s, or the host link at 64 GB/s), never by FLOPs: these passes
do about one multiply-add a byte."""

from gpubench.roofline import step_least_s
from gpubench.stats import iteration_times


def read(run):
    shapes = run.get("shapes")
    if not shapes:
        return None
    wire = run["wire_bytes_per_iter"] or 0
    least = 0.0
    for p in run["paths"]:
        for i, s in enumerate(p["solver_stats"]):
            if p["trip_log"]:
                trips = [tuple(t) for t in p["trip_log"][i]]
            else:
                trips = [(s["newton_trips"], s["cg_trips"])]
            least += step_least_s(shapes, trips, wire)
    return 100.0 * least / sum(iteration_times(run))
