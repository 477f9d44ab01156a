"""head_ms_per_iter (ms): the card's time in the dense head's part of the
data passes an iteration (the span `head_pass` in ops/tron_multi.py:
_xv_lm, _xtv_lm and _xtv_and_sqdiag_lm's bf16 head widening and GEMMs),
inside the device loops and in eager passes, over the window's
iterations. Excludes the K1 calls and the ELL's gather."""

from gpubench.spans import ms_per_iteration


def read(run, store=None):
    return ms_per_iteration(run, store, "head_pass")
