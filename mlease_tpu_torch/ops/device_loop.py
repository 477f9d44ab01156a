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
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Mapping, Sequence

import torch

from mlease_tpu_torch.ops import _build

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
        for fn in (lib.device_loop_build, lib.device_loop_node_types,
                   lib.device_loop_launch, lib.device_loop_destroy):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class DeviceLoop:
    """branches: (phase number, name, function) in pass order; phase: the
    0-d int32 phase word; state: every tensor the branches write (put back
    after the warm-up); kernels: name -> kernel wrapper or collective, a
    function with a `launches` count and a `device_launches` slot (None,
    or a 0-d int64 tensor on the card that the wrapper adds one to after
    each launch); pool: the graph memory pool to capture into (a
    `torch.cuda.graph_pool_handle()` shared with loops that run on the
    same stream, never at once), or None for one of its own."""

    def __init__(self, branches: Sequence[tuple[int, str, Callable[[], None]]],
                 phase: torch.Tensor, state: Sequence[torch.Tensor],
                 kernels: Mapping[str, Callable] | None = None, pool=None):
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
        # executions of each branch, then of each kernel, counted on the
        # device
        self.runs = torch.zeros(len(branches) + len(self.kernels),
                                dtype=torch.int64, device=self.device)
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
        self.branches[k][2]()
        self.runs.narrow(0, k, 1).add_(1)

    def prepare(self) -> None:
        """Warm up, capture and build (CUDA); nothing on the CPU."""
        if not self.on_card or self._handles is not None:
            return
        lib = _load()
        saved = [t.clone() for t in (*self.state, self.phase)]
        collective = set()
        for k in range(len(self.branches)):
            before = {c: fn.launches for c, fn in self.kernels.items()}
            self._body(k)
            if any(getattr(fn, "collective", False)
                   and fn.launches != before[c]
                   for c, fn in self.kernels.items()):
                collective.add(k)
        for t, c in zip((*self.state, self.phase), saved):
            t.copy_(c)
        self.runs.zero_()
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
        if not self.on_card:
            while True:
                for k, (want, _, _) in enumerate(self.branches):
                    if int(self.phase) == want:
                        self._body(k)
                if int(self.phase) == 0:
                    return
        if self._handles is None:
            raise RuntimeError("DeviceLoop.run before prepare()")
        err = _load().device_loop_launch(
            self._handles[1],
            ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"device_loop_launch failed: CUDA error {err}")

    def counts(self) -> dict:
        """What the loop ran so far, from one host read: each branch's
        executions; on the card also each kernel's launches captured per
        branch, and its executions as counted on the card."""
        n = self.runs.cpu().tolist()
        out = {"branch_executions": dict(zip(self.names, n))}
        if self.on_card:
            out["captured_launches"] = self.captured
            out["capture_modes"] = self.capture_modes
            out["node_types"] = self.node_types
            out["kernel_executions"] = dict(zip(self.kernels,
                                                n[len(self.names):]))
        return out

    def close(self) -> None:
        """Free the graphs and let go of the branches and the state: what
        stays is the counts."""
        if self._handles is not None:
            _load().device_loop_destroy(*self._handles)
            self._handles = None
        self._graphs.clear()
        self.branches, self.state = [], []
