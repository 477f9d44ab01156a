"""host_rss_peak_gb (GB): the process's peak resident set, getrusage's
ru_maxrss, read when the window has closed (before the reference)."""


def read(run):
    return run["rss_peak_bytes"] / 1e9
