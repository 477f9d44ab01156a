"""Profiling / tracing hooks.

Port of mlease_tpu/utils/profiling.py on torch.profiler. `trace(dir)` wraps
a region in a profiler trace of the host and, when a card is present, the
device, and writes it into the directory as a Chrome trace
(`trace-<pid>.json`, viewable in chrome://tracing or Perfetto); `Timings`
collects named wall-clock spans. The ADMM trainers additionally record
per-iteration wall times in AdmmResult.iter_times and log them per
iteration (the analogue of the reference's convergence log lines,
RegressionAdmmTrain.java:465-466).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the enclosed region, written to
    `log_dir/trace-<pid>.json` (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Timings:
    """Named wall-clock span collector."""

    def __init__(self):
        self.spans: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.spans[name].append(time.monotonic() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, times in self.spans.items():
            out[name] = {"count": len(times), "total_s": sum(times),
                         "mean_s": sum(times) / len(times)}
        return out
