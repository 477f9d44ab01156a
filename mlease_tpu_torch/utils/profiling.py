"""The program's spans, kept in memory, and torch.profiler traces.

Port of mlease_tpu/utils/profiling.py on torch.profiler, with a span store
of its own in place of the JAX package's `Timings`.

Spans. `span(name)` times a region of host code on the host's monotonic
clock (`time.perf_counter_ns`, the clock of `time.perf_counter`) and keeps
it in one in-memory store of at most MAX_SPANS spans (those past it are
counted, not kept). Each span keeps its name, start and end, its parent
(the innermost span open on the thread when it began, as an index into
the store; -1 for none) and the (run, iteration) it belongs to: a trainer's
`run()` takes a new run id (`new_run`), its iterations their numbers, and
a span inside inherits both from its parent. `record` adds a span measured
on a device's clock (ops/device_loop.py::DeviceClock): a slot's
nanoseconds and executions over one iteration, and for a device loop's
launch its start and end on the device's clock, which `recorded()` maps
onto the host clock by the offset the clock notes at each iteration's
read (`note_offset`). `recorded()` returns a copy of the store and
`reset()` empties it. While a torch.profiler trace is running, every host
span is also a `record_function` of the same name, on the trace's clock.

The spans the port records:

  to_hybrid         core/dataset.py::to_hybrid, each conversion
  admm_iteration    AdmmTrainer.run, each iteration
  stream_iteration  StreamingAdmmTrainer.run, each iteration
  admm_epilogue     AdmmTrainer.run after the last iteration (z and u to
  stream_epilogue   the host, LinearModel.from_dense); the streaming one
  <loop>/launch     a device loop's launches in an iteration, and the
                    last one's start and end (device clock; `<loop>` is
                    "x" in memory, "group<g>" for a streamed group)
  <loop>/<branch>   the time and runs of one branch of that loop
  head_pass         the dense head's part of a data pass (ops/tron_multi.py:
                    a bf16 head's kernels, ops/head_pass.py, or the
                    widening and its GEMMs)
  head_fused        inside head_pass, where the kernels of ops/head_pass.py
                    ran (its executions over head_pass's: their share)
  head_gemm         inside head_pass, where the head took torch's products
                    instead (the widening where needed, cuBLAS on the card)
  tail_pass         a data pass's K1 calls (sorted tails, the ELL's copy)
  tail_bf16         inside tail_pass, the K1 calls that read bfloat16
                    (K1's bf16 entry)
  wire_wait         a streamed group's stall on its copies (the compute
                    stream waiting on the copy stream's event)

The device spans are children of their iteration.

`trace(dir)` wraps a region in a profiler trace of the host and, when a
card is present, the device, and writes it into the directory as a Chrome
trace (`trace-<pid>.json`, viewable in chrome://tracing or Perfetto), with
each device loop's launches in the region added as a track of their own
on the trace's clock: torch.profiler does not see the kernels inside the
loops' conditional graphs. The ADMM trainers also record per-iteration
wall times in AdmmResult.iter_times and log them per iteration (the
analogue of the reference's convergence log lines,
RegressionAdmmTrain.java:465-466).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from typing import NamedTuple

import torch

logger = logging.getLogger(__name__)

MAX_SPANS = 1_000_000
LAUNCH = "/launch"             # the name's suffix of a device loop's launch
ANCHOR = "profiling.clock_anchor"


class Span(NamedTuple):
    """One span of the store. start and end in host nanoseconds (None for
    a device slot's per-iteration total, which has no one interval); ns
    and executions for a span measured on `device`'s clock."""
    name: str
    start: int | None
    end: int | None
    parent: int
    run: int
    iteration: int
    ns: int | None = None
    executions: int | None = None
    device: str | None = None


_lock = threading.Lock()
_spans: list[Span] = []
_dropped = 0
_generation = 0
_offsets: dict[str, list] = {}   # device -> [upper estimate, lower bound]
_runs = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _context() -> tuple[int, int, int]:
    """(parent index, run, iteration) of a span that begins now."""
    stack = _stack()
    return stack[-1][:3] if stack else (-1, 0, 0)


def _append(span: Span) -> int:
    global _dropped
    with _lock:
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
            return -1
        _spans.append(span)
        return len(_spans) - 1


def new_run() -> int:
    """A new run id, for the spans of one trainer's run()."""
    return next(_runs)


@contextlib.contextmanager
def span(name: str, *, run: int | None = None,
         iteration: int | None = None):
    """Time the enclosed host code as span `name` (a child of the
    innermost open span; run and iteration inherited from it unless
    given); yields the span's index in the store (-1 once it is full)."""
    parent, prun, pit = _context()
    run = prun if run is None else run
    iteration = pit if iteration is None else iteration
    rf = None
    if torch.autograd._profiler_enabled():
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    gen = _generation
    start = time.perf_counter_ns()
    i = _append(Span(name, start, None, parent, run, iteration))
    stack = _stack()
    stack.append((i, run, iteration))
    try:
        yield i
    finally:
        end = time.perf_counter_ns()
        stack.pop()
        if i >= 0:
            with _lock:
                if gen == _generation:
                    _spans[i] = _spans[i]._replace(end=end)
        if rf is not None:
            rf.__exit__(None, None, None)


def timed(name: str):
    """Decorator: every call of the function is span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def record(name: str, *, ns: int, executions: int, device: str,
           start: int | None = None, end: int | None = None) -> None:
    """A span measured on `device`'s clock, a child of the innermost open
    span: ns and executions over it, and start and end on that clock
    (a loop launch's)."""
    parent, run, iteration = _context()
    _append(Span(name, start, end, parent, run, iteration, int(ns),
                 int(executions), device))


def note_offset(device: str, upper: int | None, lower: int | None) -> None:
    """Host minus device clock, read at one sync: `upper` is at least the
    true offset (the host's time after a read less a stamp made before
    it), `lower` at most (the host's time before it enqueued a stamp less
    the stamp). The store keeps the least upper and the greatest lower."""
    with _lock:
        best = _offsets.setdefault(device, [None, None])
        if upper is not None and (best[0] is None or upper < best[0]):
            best[0] = upper
        if lower is not None and (best[1] is None or lower > best[1]):
            best[1] = lower


def recorded() -> dict:
    """The store: {"spans": [Span] (device intervals mapped onto the host
    clock by the least upper offset, so each lies at most `error_ns` late),
    "dropped": spans past MAX_SPANS, "clocks": {device: {"offset_ns",
    "error_ns"}}}."""
    with _lock:
        spans = list(_spans)
        dropped = _dropped
        offsets = {d: tuple(v) for d, v in _offsets.items()}
    out = []
    for s in spans:
        if s.device is not None and s.start is not None:
            upper = offsets.get(s.device, (None, None))[0]
            s = s._replace(start=None if upper is None else s.start + upper,
                           end=None if upper is None else s.end + upper)
        out.append(s)
    clocks = {d: {"offset_ns": up,
                  "error_ns": None if up is None or lo is None else up - lo}
              for d, (up, lo) in offsets.items()}
    return {"spans": out, "dropped": dropped, "clocks": clocks}


def reset() -> None:
    """Empty the store (spans open now are not kept when they close)."""
    global _dropped, _generation
    with _lock:
        _spans.clear()
        _offsets.clear()
        _dropped = 0
        _generation += 1


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace of the enclosed region, written to
    `log_dir/trace-<pid>.json` with the region's device loop launches
    added as a track (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_spans)
    with profile(activities=activities) as prof:
        # a known host instant on the trace's clock
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(ANCHOR):
            t1 = time.perf_counter_ns()
        yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    added = _add_loop_tracks(path, (t0 + t1) // 2,
                             recorded()["spans"][first:])
    logger.info("profiler trace written to %s (%d device loop launches)",
                path, added)


def _add_loop_tracks(path: str, anchor_ns: int, spans) -> int:
    """Add each device loop launch among `spans` to the Chrome trace at
    `path` as a complete event on a track of its own (one process, one
    thread a loop), on the trace's clock: the trace's ANCHOR event began
    at host time anchor_ns. Returns the events added."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    anchor = next((e for e in events if e.get("name") == ANCHOR
                   and "ts" in e), None)
    launches = [s for s in spans if s.name.endswith(LAUNCH)
                and s.start is not None and s.end is not None]
    if anchor is None or not launches:
        return 0
    shift_us = float(anchor["ts"]) - anchor_ns / 1e3
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    tids = {name: k for k, name in enumerate(
        sorted({s.name for s in launches}))}
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": "device loops (the card's clock)"}})
    for name, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for s in launches:
        events.append({"ph": "X", "cat": "device_loop", "name": s.name,
                       "pid": pid, "tid": tids[s.name],
                       "ts": s.start / 1e3 + shift_us,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"run": s.run, "iteration": s.iteration,
                                "device_ns": s.ns}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(launches)
