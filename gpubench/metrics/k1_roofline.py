"""k1_roofline (%): kernel K1 (ops/segment_sum.py, csrc/segment_sum.cu)
timed alone through its public wrapper on the cell's first solve's
column-sorted tail stream (T entries into S = B n segments, L lanes
gathered from B R rows), against its bytes over the HBM rate
(gpubench/roofline.py::k1_bytes)."""

from gpubench.roofline import k1_bound_s


def read(run):
    k1 = run.get("k1")
    if not k1 or not k1.get("seconds"):
        return None
    return 100.0 * k1_bound_s(k1["T"], k1["S"], k1["rows"],
                              k1["L"]) / k1["seconds"]
