"""setup_s (s): process start to the end of the warm-up path: imports,
the data made on the card, the trainer's build, the first path (the
device loops' capture and, in a fresh checkout, the kernels' build)."""


def read(run):
    return run["setup_s"]
