"""tail_ms_per_iter (ms): the card's time in the data passes' K1 calls an
iteration (the span `tail_pass` in ops/tron_multi.py: the sorted tails
and the ELL's column-sorted copy), inside the device loops and in eager
passes, over the window's iterations. The solver's K1 at its own
inputs, where k1_roofline times K1 alone on a stream of the harness."""

from gpubench.spans import ms_per_iteration


def read(run, store=None):
    return ms_per_iteration(run, store, "tail_pass")
