"""head_roofline (%): the dense head's share of its bandwidth bound in the
data passes. The least time: each of the window's solves reads its head
once a pass (R H bytes of the stored head, per gpubench/roofline.py's
ProblemShape), two passes a Newton or CG trip (roofline.passes, the
program's trip counts), over the HBM rate; against the card's time in the
span `head_pass` (ops/tron_multi.py) over the same iterations. It counts
the head's bytes alone and the passes the trips imply (the solver runs a
few more), so it can only read low. None without the cell's shapes, where
the program keeps no store or its store dropped spans, and where the spans
were not timed on a card."""

from gpubench import roofline, spans


def read(run, store=None):
    shapes = run.get("shapes")
    st = spans.store() if store is None else store
    if not shapes or st is None or st.get("dropped"):
        return None
    found = spans.in_window(run, st["spans"], ("head_pass",))
    if not found or not all(str(s.device).startswith("cuda")
                            for s in found):
        return None
    head_bytes = 0
    for p in run["paths"]:
        for i, s in enumerate(p["solver_stats"]):
            trips = ([tuple(t) for t in p["trip_log"][i]] if p["trip_log"]
                     else [(s["newton_trips"], s["cg_trips"])])
            head_bytes += sum(roofline.passes(*t) * sh.R * sh.H
                              * sh.head_itemsize
                              for sh, t in zip(shapes, trips))
    seconds = sum(s.ns for s in found) / 1e9
    if seconds <= 0:
        return None
    return 100.0 * head_bytes / roofline.HBM_BYTES_PER_S / seconds
