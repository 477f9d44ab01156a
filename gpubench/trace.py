"""What a `--trace 1` run reads besides the window: the card's utilization
sampled by NVML, K1 timed alone on the cell's own tail stream, and one
path under torch.profiler for the breakdown."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

LONG_GAPS = 200
NAME_CHARS = 160


class UtilSampler:
    """`nvidia-smi` sampling utilization.gpu every 100 ms as a child
    process: the share of each period in which a kernel ran, CUDA graphs
    included."""

    def __init__(self, index: int = 0):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100",
             "-i", str(index)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list[float]:
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return [float(v) for v in out.split() if v.strip().isdigit()]


def tail_stream(idx: torch.Tensor, val: torch.Tensor, n: int, H: int):
    """The column-sorted tail stream of B stacked blocks (idx, val (B, R,
    K)): the entries off the H columns with the most nonzeros, as
    (values, gather ids b R + row, segment ids b n + column), sorted by
    segment. -> (vals, idx, seg, T, S, rows)."""
    B, R, K = idx.shape
    counts = torch.bincount(idx[val != 0].long(), minlength=n)
    head = torch.zeros(n, dtype=torch.bool, device=idx.device)
    head[torch.sort(-counts, stable=True).indices[:H]] = True
    keep = (~head[idx.long()]) & (val != 0)
    rows = (torch.arange(B * R, device=idx.device, dtype=torch.int64)
            .view(B, R, 1).expand(B, R, K))[keep]
    seg = (idx.long() + torch.arange(B, device=idx.device)
           .view(B, 1, 1) * n)[keep]
    vals = val[keep]
    order = torch.sort(seg, stable=True).indices
    return (vals[order].contiguous(), rows[order].to(torch.int32),
            seg[order].to(torch.int32), int(keep.sum()), B * n, B * R)


def time_k1(vals, gidx, seg, S: int, rows: int, L: int,
            reps: int = 20) -> float:
    """Seconds of one K1 call (the program's public wrapper) over the
    stream into zero-filled (L, S) sums, CUDA events over `reps` calls
    after three."""
    from mlease_tpu_torch.ops.segment_sum import segment_sum_gather

    g = torch.Generator(device=vals.device)
    g.manual_seed(0)
    D = torch.randn((L, rows), dtype=vals.dtype, device=vals.device,
                    generator=g)
    out = torch.zeros((L, S), dtype=vals.dtype, device=vals.device)
    for _ in range(3):
        segment_sum_gather(vals, D, gidx, seg, S, out=out)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        segment_sum_gather(vals, D, gidx, seg, S, out=out)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _device_time_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(ev, name, None)
        if v is not None:
            return float(v)
    return 0.0


def read_profile(prof, top: int = 10) -> dict:
    """From one profiled path: the device operations that took most time,
    the device's busy seconds (the union of its kernels' and copies'
    intervals) over the profiled span, and the idle gaps between them
    summed by the innermost host span or operation that was running when
    each gap began."""
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev.append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name))
    # a host span (record_function) shows on the device's timeline too:
    # only kernels, copies and sets count as device operations
    host_names = {h[2] for h in host}
    dev = [(a, b) for a, b, name in dev if name not in host_names]
    ops = sorted(((ev.key, _device_time_us(ev) / 1e6)
                  for ev in prof.key_averages()
                  if ev.key not in host_names), key=lambda kv: -kv[1])
    device_ops = [[k[:NAME_CHARS], v] for k, v in ops if v > 0][:top]
    span = [h for h in host if h[2] == "gpubench.path"]
    lo, hi = ((span[0][0], span[0][1]) if span else
              (min(h[0] for h in host), max(h[1] for h in host)))
    dev = sorted((max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi)
    busy, gaps, cur = 0.0, [], lo
    for a, b in dev:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    # the longest gaps each named by the innermost host event running at
    # its middle (host code between torch calls shows as the path's own
    # span); the many short ones summed under one name
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    by_name: dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:LONG_GAPS]:
        mid = 0.5 * (a + b)
        inside = (starts <= mid) & (ends > mid)
        name = ("host code outside torch calls" if not inside.any() else
                names[int(np.argmin(np.where(inside, ends - starts,
                                             np.inf)))])
        if name == "gpubench.path":
            name = "host code outside torch calls"
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[LONG_GAPS:]) / 1e6
    if rest > 0:
        by_name["(shorter gaps)"] = rest
    idle = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": device_ops,
            "idle_gaps": [[k, v] for k, v in idle],
            "busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6}
