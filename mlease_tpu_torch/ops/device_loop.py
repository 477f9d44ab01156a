"""A state machine of tensor branches that loops on the card, without the host.

The counterpart of a `lax.while_loop` whose body picks one of a few
branches: an x-update's TRON loops (train/admm.py::_SolveLoop: one CG
trip, the Newton epilogue, the CG start, for each solve) in run() and the
streaming trainer, and AdmmTrainer.run_fused's driver loop (those, the
end of an ADMM iteration and the next x-update's start). Each branch is
a function that reads and writes only tensors made
before the loop (its static state) and ends by writing the next phase into
`phase`, a 0-d int32 tensor; phase 0 stops the loop. One pass of the loop
runs the branches in the order given, each when the phase equals its own
number at that moment, so one pass can carry a CG trip, the Newton step
after it, the end of the iteration and the next one's start:

    while phase != 0:
        for want, fn in branches:
            if phase == want: fn()

On a CUDA device `prepare` runs every branch once eagerly (which builds the
kernels' libraries and the libraries' handles, and an NCCL communicator at
its first collective), puts the state back, captures each branch as a
torch CUDA graph (one memory pool for all) and builds the loop around them
by hand (csrc/device_loop.cu: a conditional WHILE node over one IF node per
branch, each IF's condition set from the phase word by a one-thread
kernel). A branch whose warm-up called a collective (a counted function
marked `collective`, collectives.all_reduce) is captured in
"thread_local" mode: in the default "global" mode NCCL's watchdog thread,
which queries events meanwhile, would break the capture. A conditional
body may hold only kernel, memcpy, memset, empty, child-graph and
conditional nodes: if a capture leaves another node in a branch, the build
fails and `prepare` raises, naming the branch and the node type; nothing
falls back to running the branches eagerly. `run` is then one graph launch on the
current stream: no host read, no host wait, until the caller synchronises.
torch exposes no conditional nodes on the card's torch (2.11), hence the
hand-built graph. On the CPU `run` takes the same passes eagerly and reads
the phase on the host after every branch.

Loops may share one graph memory pool (`pool=`): every tensor a branch
allocates is freed before its capture ends, so no graph keeps memory that
another writes, and loops that run one after another on one stream may
reuse each other's temporaries (one trainer's loops share one pool).

Counting: a kernel wrapper's launch counter counts Python calls, so inside
a graph it counts captures. While it captures, the loop gives each kernel
wrapper a slot of a device counter (the wrapper's `device_launches`); the
wrapper adds one to it on the stream right after its kernel, so the
captured add runs on the card each time the kernel has run, and
`counts()` reads the kernels' executions from the card. The loop also
records each branch's captured launches and counts each branch's
executions on the device, which gives the same numbers a second way.
A wrapper's `launches` stays its own: it holds the warm-up's launches and
the calls the captures recorded, and none of the executions on the card,
which only `counts()` reports. So the runs of a kernel in some span are
its `launches` over the span, less the calls captured in it, plus the
executions the loops counted on the card in it.

Timing: a loop's counters are a table of clock slots (`table`, int64
[open, total ns, executions, closed] a row: each branch, each kernel,
then the whole launch; `runs` is its executions column of the branches
and kernels). Each branch runs between an open and a close stamp of its
row, captured into its graph (csrc/device_loop.cu: one-thread kernels
that read the card's %globaltimer), and `run` stamps the launch's row
around the graph launch on the same stream, so a launch's time less its
branches' is the loop's own (the condition kernels and the conditional
nodes). On the CPU the same stamps read time.perf_counter_ns around the
eager branches. `DeviceClock` is a trainer's clock: slots of its own
(head_pass, tail_pass, wire_wait), which `device_span` stamps while the
clock is `active` (in eager code and, when a loop is captured meanwhile,
inside its branches), and the tables of its loops; `read` joins them all
to the iteration's one host read and records each slot's per-iteration
time and runs as spans of utils/profiling.py.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.ops import _build
from mlease_tpu_torch.utils import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "device_loop.cu"

_lib = None

# cudaGraphNodeType by value (driver_types.h, CUDA 12.4; 12 is the driver
# API's batch-mem-op node); the last entry also counts any type past it
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semaphore_signal",
              "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "other")


def _load():
    """The loop's library, built at first use."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp = ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.device_loop_build.argtypes = [
            ctypes.POINTER(vp), ip, ctypes.c_int, vp, ctypes.POINTER(vp),
            ctypes.POINTER(vp), ip]
        lib.device_loop_node_types.argtypes = [vp, ip, ctypes.c_int]
        lib.device_loop_launch.argtypes = [vp, vp]
        lib.device_loop_destroy.argtypes = [vp, vp]
        lib.device_clock_stamp.argtypes = [vp, ctypes.c_int, vp]
        lib.device_clock_nodes.argtypes = [vp, vp, ip]
        for fn in (lib.device_loop_build, lib.device_loop_node_types,
                   lib.device_loop_launch, lib.device_loop_destroy,
                   lib.device_clock_stamp, lib.device_clock_nodes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


SLOT_BYTES = 32           # a clock slot: int64 [open, total, runs, closed]


def _slots(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((n, 4), dtype=torch.int64, device=device)


def _stamp(table: torch.Tensor, host, row: int, close: bool) -> None:
    """Open (close=False) or close slot `row` of `table`: on the card a
    stamp kernel on the current stream; on the CPU the host clock written
    through `host`, the table's numpy view."""
    if host is not None:
        t = time.perf_counter_ns()
        slot = host[row]
        if close:
            slot[1] += t - slot[0]
            slot[2] += 1
            slot[3] = t
        else:
            slot[0] = t
        return
    err = _load().device_clock_stamp(
        ctypes.c_void_p(table.data_ptr() + SLOT_BYTES * row), int(close),
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"device_clock_stamp failed: CUDA error {err}")


def stamp_nodes(graph: int, table: torch.Tensor, row: int) -> tuple[int, int]:
    """(open, close) stamp kernel nodes on slot `row` of `table` in a
    captured graph (a raw cudaGraph_t) and its child graphs."""
    counts = (ctypes.c_int * 2)()
    err = _load().device_clock_nodes(
        ctypes.c_void_p(graph),
        ctypes.c_void_p(table.data_ptr() + SLOT_BYTES * row), counts)
    if err != 0:
        raise RuntimeError(f"device_clock_nodes failed: CUDA error {err}")
    return counts[0], counts[1]


_active: "DeviceClock | None" = None


@contextlib.contextmanager
def device_span(name: str):
    """Stamp the active clock's slot `name` around the enclosed device
    work (nothing when no clock is active or it has no such slot)."""
    clock = _active
    row = None if clock is None else clock.rows.get(name)
    if row is None:
        yield
        return
    _stamp(clock.table, clock.host, row, False)
    try:
        yield
    finally:
        _stamp(clock.table, clock.host, row, True)


class DeviceClock:
    """One trainer's clock on its device: named slots of its own (static
    from here on, so captured stamps keep their pointers) and the tables of
    the loops made with it. `read` is the iteration's one host read: it
    takes the slots beside the tensors the iteration reads anyway and
    records the deltas since the last read as spans of the innermost open
    span (utils/profiling.py). The offset from the card's clock to the
    host's is noted at each read: the host's time after the read less a
    stamp enqueued just before it bounds it from above; the host's time
    before it enqueued a stamp at the iteration's start, when the stream
    was idle (`idle_stamp`), less that stamp, from below."""

    def __init__(self, device, names: Sequence[str] = ()):
        self.device = torch.device(device)
        self.names = [*names, "sync", "sync_idle"]
        self.rows = {name: k for k, name in enumerate(self.names)}
        self.table = _slots(len(self.names), self.device)
        self.host = None if self.device.type == "cuda" else self.table.numpy()
        self.loops: list[DeviceLoop] = []
        self._last: dict[int, np.ndarray] = {}
        self._idle_at: int | None = None

    @contextlib.contextmanager
    def active(self):
        """Make this the clock `device_span` stamps."""
        global _active
        prev, _active = _active, self
        try:
            yield
        finally:
            _active = prev

    def tables(self) -> list[torch.Tensor]:
        return [self.table] + [lp.table for lp in self.loops]

    def drop(self, loop: "DeviceLoop") -> None:
        if loop in self.loops:
            self.loops.remove(loop)
        self._last.pop(id(loop), None)

    def idle_stamp(self) -> None:
        """At an iteration's start, the stream idle since the last read."""
        self._idle_at = time.perf_counter_ns()
        _stamp(self.table, self.host, self.rows["sync_idle"], False)

    def read(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The 1-d `tensors` as one float64 host tensor, read in one copy
        with the clock's slots; records the slots' deltas."""
        _stamp(self.table, self.host, self.rows["sync"], False)
        owners = [self, *self.loops]
        flat = [t.to(torch.float64).view(torch.int64) for t in tensors]
        k = sum(t.numel() for t in flat)
        host = torch.cat(flat + [o.table.view(-1) for o in owners]).cpu()
        now = time.perf_counter_ns()
        self._took(host[k:].numpy(), owners, now)
        return host[:k].view(torch.float64)

    def _took(self, snap: np.ndarray, owners: list, now: int) -> None:
        dev = str(self.device)
        own = snap[:self.table.numel()].reshape(-1, 4)
        if self.host is None:
            idle = own[self.rows["sync_idle"], 0]
            profiling.note_offset(
                dev, now - int(own[self.rows["sync"], 0]),
                None if self._idle_at is None or idle == 0
                else self._idle_at - int(idle))
        else:
            profiling.note_offset(dev, 0, 0)
        self._idle_at = None
        off = 0
        for owner in owners:
            n = owner.table.numel()
            cur = snap[off:off + n].reshape(-1, 4).copy()
            off += n
            last = self._last.get(id(owner))
            self._last[id(owner)] = cur
            d = cur if last is None else cur - last
            for row, name, launch in owner.timed_rows():
                if d[row, 2] <= 0:
                    continue
                profiling.record(
                    name, ns=d[row, 1], executions=d[row, 2], device=dev,
                    start=int(cur[row, 0]) if launch else None,
                    end=int(cur[row, 3]) if launch else None)

    def timed_rows(self) -> list[tuple[int, str, bool]]:
        """(row, span name, is a launch) of each slot but the two syncs."""
        return [(k, name, False) for k, name in enumerate(self.names[:-2])]


class DeviceLoop:
    """branches: (phase number, name, function) in pass order; phase: the
    0-d int32 phase word; state: every tensor the branches write (put back
    after the warm-up); kernels: name -> kernel wrapper or collective, a
    function with a `launches` count and a `device_launches` slot (None,
    or a 0-d int64 tensor on the card that the wrapper adds one to after
    each launch); pool: the graph memory pool to capture into (a
    `torch.cuda.graph_pool_handle()` shared with loops that run on the
    same stream, never at once), or None for one of its own; clock: the
    trainer's DeviceClock whose read takes this loop's table (None: the
    table is read by `counts` alone); name: the loop's name in the
    clock's spans."""

    def __init__(self, branches: Sequence[tuple[int, str, Callable[[], None]]],
                 phase: torch.Tensor, state: Sequence[torch.Tensor],
                 kernels: Mapping[str, Callable] | None = None, pool=None,
                 clock: DeviceClock | None = None, name: str = "loop"):
        if phase.dtype != torch.int32 or phase.dim() != 0:
            raise ValueError("phase must be a 0-d int32 tensor")
        wants = [w for w, _, _ in branches]
        if 0 in wants or len(set(wants)) != len(wants):
            raise ValueError(f"branch phases must be distinct and non-zero; "
                             f"got {wants}")
        self.branches = list(branches)
        self.names = [name for _, name, _ in branches]
        self.phase = phase
        self.state = list(state)
        self.kernels = dict(kernels or {})
        self.device = phase.device
        self.name = name
        # clock slots of each branch, then of each kernel, then the launch;
        # runs: their executions, counted on the device
        nk = len(branches) + len(self.kernels)
        self.table = _slots(nk + 1, self.device)
        self.host = None if self.on_card else self.table.numpy()
        self.runs = self.table[:nk, 2]
        self.launch_row = nk
        self.clock = clock
        if clock is not None:
            clock.loops.append(self)
        self.captured: dict[str, dict[str, int]] = {}
        self.capture_modes: dict[str, str] = {}
        self.node_types: dict[str, dict[str, int]] = {}
        self.pool = pool
        self._graphs: list = []
        self._handles = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def _body(self, k: int) -> None:
        _stamp(self.table, self.host, k, False)
        self.branches[k][2]()
        _stamp(self.table, self.host, k, True)

    def timed_rows(self) -> list[tuple[int, str, bool]]:
        """(row, span name, is the launch) of each timed slot."""
        return [(k, f"{self.name}/{b}", False)
                for k, b in enumerate(self.names)] + \
            [(self.launch_row, self.name + profiling.LAUNCH, True)]

    def prepare(self) -> None:
        """Warm up, capture and build (CUDA); nothing on the CPU."""
        if not self.on_card or self._handles is not None:
            return
        lib = _load()
        # the warm-up's stamps are put back with the state
        clocks = self.clock.tables() if self.clock else [self.table]
        saved = [t.clone() for t in (*self.state, self.phase, *clocks)]
        collective = set()
        for k in range(len(self.branches)):
            before = {c: fn.launches for c, fn in self.kernels.items()}
            self._body(k)
            if any(getattr(fn, "collective", False)
                   and fn.launches != before[c]
                   for c, fn in self.kernels.items()):
                collective.add(k)
        for t, c in zip((*self.state, self.phase, *clocks), saved):
            t.copy_(c)
        del saved
        torch.cuda.synchronize(self.device)
        pool = (self.pool if self.pool is not None
                else torch.cuda.graph_pool_handle())
        first = len(self.branches)
        try:
            for i, fn in enumerate(self.kernels.values()):
                fn.device_launches = self.runs[first + i]
            for k, name in enumerate(self.names):
                before = {c: fn.launches for c, fn in self.kernels.items()}
                mode = "thread_local" if k in collective else "global"
                g = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(g, pool=pool, capture_error_mode=mode):
                    self._body(k)
                self.captured[name] = {c: fn.launches - before[c]
                                       for c, fn in self.kernels.items()}
                self.capture_modes[name] = mode
                self._graphs.append(g)
        finally:
            for fn in self.kernels.values():
                fn.device_launches = None
        vp = ctypes.c_void_p
        raw = (vp * len(self._graphs))(
            *[vp(g.raw_cuda_graph()) for g in self._graphs])
        for name, h in zip(self.names, raw):
            counts = (ctypes.c_int * len(NODE_TYPES))()
            err = lib.device_loop_node_types(h, counts, len(NODE_TYPES))
            if err != 0:
                raise RuntimeError(f"device_loop_node_types failed: CUDA "
                                   f"error {err}")
            self.node_types[name] = {t: c for t, c in zip(NODE_TYPES, counts)
                                     if c}
        wants = (ctypes.c_int * len(self.branches))(
            *[w for w, _, _ in self.branches])
        graph, exec_ = vp(), vp()
        bad = (ctypes.c_int * 2)()
        err = lib.device_loop_build(raw, wants, len(self.branches),
                                    vp(self.phase.data_ptr()),
                                    ctypes.byref(graph), ctypes.byref(exec_),
                                    bad)
        if bad[0] >= 0:
            kind = (NODE_TYPES[bad[1]] if bad[1] < len(NODE_TYPES)
                    else f"type {bad[1]}")
            raise RuntimeError(
                f"device loop: the captured branch {self.names[bad[0]]!r} "
                f"holds a {kind} node, which a conditional body cannot "
                f"hold (its nodes: {self.node_types[self.names[bad[0]]]})")
        if err != 0:
            raise RuntimeError(f"device_loop_build failed: CUDA error {err}")
        self._handles = (graph, exec_)

    def run(self) -> None:
        """Run the loop until the phase is 0: one graph launch on the
        current stream (CUDA; nothing waits for it), or eagerly with the
        phase read on the host (CPU)."""
        if self.on_card and self._handles is None:
            raise RuntimeError("DeviceLoop.run before prepare()")
        _stamp(self.table, self.host, self.launch_row, False)
        if not self.on_card:
            while True:
                for k, (want, _, _) in enumerate(self.branches):
                    if int(self.phase) == want:
                        self._body(k)
                if int(self.phase) == 0:
                    break
        else:
            err = _load().device_loop_launch(
                self._handles[1], ctypes.c_void_p(
                    torch.cuda.current_stream(self.device).cuda_stream))
            if err != 0:
                raise RuntimeError(f"device_loop_launch failed: CUDA error "
                                   f"{err}")
        _stamp(self.table, self.host, self.launch_row, True)

    def counts(self) -> dict:
        """What the loop ran so far, from one host read: each branch's
        executions and nanoseconds, the launches and their nanoseconds; on
        the card also each kernel's launches captured per branch, and its
        executions as counted on the card."""
        t = self.table.cpu()
        n, ns = t[:, 2].tolist(), t[:, 1].tolist()
        nb = len(self.names)
        out = {"branch_executions": dict(zip(self.names, n)),
               "branch_ns": dict(zip(self.names, ns)),
               "loop_launches": n[self.launch_row],
               "loop_ns": ns[self.launch_row]}
        if self.on_card:
            out["captured_launches"] = self.captured
            out["capture_modes"] = self.capture_modes
            out["node_types"] = self.node_types
            out["kernel_executions"] = dict(zip(self.kernels,
                                                n[nb:self.launch_row]))
        return out

    def close(self) -> None:
        """Free the graphs and let go of the branches and the state: what
        stays is the counts."""
        if self._handles is not None:
            _load().device_loop_destroy(*self._handles)
            self._handles = None
        if self.clock is not None:
            self.clock.drop(self)
            self.clock = None
        self._graphs.clear()
        self.branches, self.state = [], []
