"""head_gemm_ms_per_iter (ms): the card's time in the dense head's torch
products an iteration (the span `head_gemm` inside `head_pass`,
ops/tron_multi.py: a bf16 solve's batched bf16 bmm for Xv and one GEMM a
block for X'v and the 2L pass, the head squared in bf16 there; any
widening first), inside the device loops and in eager passes, over the
window's iterations. A head that takes the kernels of ops/head_pass.py
(a bf16 head under a float32 solve) never enters it: None there."""

from gpubench.spans import ms_per_iteration


def read(run, store=None):
    return ms_per_iteration(run, store, "head_gemm")
