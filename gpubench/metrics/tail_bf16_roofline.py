"""tail_bf16_roofline (%): K1's bf16 entry's share of its bandwidth bound
at the solver's own inputs: each pass's tail stream read once, T (2 + 2 x
4) bytes (a bf16 value and two int32 ids an entry, T from the cell's
gpubench/roofline.py ProblemShape), two passes a Newton or CG trip, over
the HBM rate (3.35 TB/s), against the card's time in the span `tail_bf16`
(the K1 calls that read bfloat16, inside `tail_pass`, ops/tron_multi.py)
over the same iterations (gpubench/span_share.py). It leaves out the
gathered operand and the outputs, so it can only read low. None where
the span is absent (a float32 solve) or untimed on a card."""

from gpubench.roofline import ID_BYTES
from gpubench.span_share import share

BF16_BYTES = 2


def read(run, store=None):
    return share(run, store, "tail_bf16",
                 lambda p: p.T * (BF16_BYTES + 2 * ID_BYTES))
