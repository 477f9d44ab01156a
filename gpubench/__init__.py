"""The benchmark of the PyTorch and CUDA port (`mlease_tpu_torch`); run
one cell with `python3 gpubench/run.py --workload <name> ...`."""
