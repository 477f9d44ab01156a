"""loop_ms_per_iter (ms): the card's time inside the x-update's device
loops an iteration: each loop launch between the clock's stamps around
its graph launch (`<loop>/launch`, ops/device_loop.py::DeviceClock),
summed over an iteration's loops (one in memory, one a group streamed),
over the window's iterations. Includes the branches and the loop's own
condition kernels; excludes the eager work around the launch (the solve's
inputs, the consensus, the read)."""

from gpubench.spans import ms_per_iteration


def read(run, store=None):
    return ms_per_iteration(run, store, "/launch")
