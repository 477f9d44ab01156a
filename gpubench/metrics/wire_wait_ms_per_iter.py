"""wire_wait_ms_per_iter (ms): the compute stream's stall on a streamed
group's copies an iteration (the span `wire_wait` around
compute.wait_event in train/streaming.py::_iterate): the part of the
wire not hidden under the solves queued before it, over the window's
iterations. Nothing where no group is shipped (every group resident)."""

from gpubench.spans import ms_per_iteration


def read(run, store=None):
    return ms_per_iteration(run, store, "wire_wait")
