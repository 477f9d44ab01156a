"""A span's share of its bandwidth bound, for the roofline readers of the
bf16 solve's spans (gpubench/metrics/head_gemm_roofline.py,
tail_bf16_roofline.py): the bytes a data pass must read of one solve
(a function of its gpubench/roofline.py ProblemShape), two passes a
Newton or CG trip of the window's paths (the program's trip counts), over
the HBM rate, against the card's time in the span over the window's
iterations. It counts the passes the trips imply (the solver runs a few
more), so it can only read low.

None without the cell's shapes (an untraced run), where the program keeps
no store, its store dropped spans or holds no such span in the window (a
program older than the span, or a cell whose solve never enters it), and
where the span was not timed on a card."""

from __future__ import annotations

from gpubench import roofline, spans


def share(run, store, span: str, pass_bytes) -> float | None:
    """100 x the least time of the window's passes over `span`'s time, %;
    `pass_bytes(shape)` the bytes one pass must read of that solve."""
    shapes = run.get("shapes")
    st = spans.store() if store is None else store
    if not shapes or st is None or st.get("dropped"):
        return None
    found = spans.in_window(run, st["spans"], (span,))
    if not found or not all(str(s.device).startswith("cuda")
                            for s in found):
        return None
    least = 0
    for p in run["paths"]:
        for i, s in enumerate(p["solver_stats"]):
            trips = ([tuple(t) for t in p["trip_log"][i]] if p["trip_log"]
                     else [(s["newton_trips"], s["cg_trips"])])
            least += sum(roofline.passes(*t) * pass_bytes(sh)
                         for sh, t in zip(shapes, trips))
    seconds = sum(s.ns for s in found) / 1e9
    if seconds <= 0:
        return None
    return 100.0 * least / roofline.HBM_BYTES_PER_S / seconds
