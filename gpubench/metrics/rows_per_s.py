"""rows_per_s (rows/s): training throughput, the rows of the job times
the ADMM iterations completed in the window, over the window's seconds
(every path's prologue and epilogue inside it)."""


def read(run):
    iters = sum(len(p["marks"]) for p in run["paths"])
    return run["rows"] * iters / run["window_s"]
