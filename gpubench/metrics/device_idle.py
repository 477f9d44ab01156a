"""device_idle (%): 100 less the mean of the card's utilization.gpu
sampled by NVML every 100 ms through the traced window (the share of each
period in which a kernel ran; it sees the kernels of CUDA graphs)."""


def read(run):
    util = run.get("nvml_util")
    if not util:
        return None
    return 100.0 - sum(util) / len(util)
