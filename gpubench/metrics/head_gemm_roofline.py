"""head_gemm_roofline (%): the dense head's torch products' share of their
bandwidth bound: the stored head read once a pass (R H bytes in its
dtype, per gpubench/roofline.py's ProblemShape), two passes a Newton or
CG trip, over the HBM rate (3.35 TB/s), against the card's time in the
span `head_gemm` (ops/tron_multi.py) over the same iterations; counted
as head_roofline counts the head's bytes (gpubench/span_share.py). A
lower bound. None where the span is absent or untimed on a card."""

from gpubench.span_share import share


def read(run, store=None):
    return share(run, store, "head_gemm",
                 lambda p: p.R * p.H * p.head_itemsize)
