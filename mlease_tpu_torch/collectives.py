"""The collectives of the mesh paths (parallel/, the trainers' mesh=, and
tron_multi's group=): every one the port makes goes through this module,
which counts them.

Every rank of the group receives the same bits from each, so the ranks'
lock-step loops stay in step. gloo takes CUDA tensors as they are (it
stages them through pinned host memory itself): handing it the CUDA tensor
is the same bits as copying to the host first, and faster
(tools/torch_gloo_cuda_probe.py).
"""

from __future__ import annotations

import time
from typing import Any

import torch
import torch.distributed as dist

# calls made and host seconds spent inside them (a gloo call on a CUDA
# tensor includes its device<->host copies; an NCCL call only its
# enqueue), for the per-iteration collective time chip_smoke.py reports;
# reset freely. A call made while a CUDA graph captures counts once, as a
# capture: the graph's executions are counted on the card (all_reduce's
# device_launches)
COLLECTIVE_STATS = {"calls": 0, "seconds": 0.0}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all_reduce of `t` over `group` ("sum" or "max"); returns t.
    Counted as a kernel wrapper is (ops/device_loop.py): `launches` per
    call, and one added on the stream to `device_launches` (when a device
    loop sets it) right after the collective, so that inside a captured
    graph the add runs on the card each time the collective has run."""
    t0 = time.perf_counter()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=rop, group=group)
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    all_reduce.launches += 1
    if all_reduce.device_launches is not None:
        all_reduce.device_launches.add_(1)
    return t


all_reduce.launches = 0
all_reduce.device_launches = None     # set by ops/device_loop.py
# a device loop captures a branch that calls it in "thread_local" mode
# (ops/device_loop.py): NCCL's watchdog thread queries events meanwhile
all_reduce.collective = True


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors (all of one shape) concatenated along `dim` in
    rank order."""
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    return out


def max_over(values, group, device) -> list[int]:
    """Integer counts (trip counts) maxed over `group`: one all_reduce."""
    t = torch.as_tensor(values, dtype=torch.int64, device=device)
    return all_reduce(t, "max", group).tolist()


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """`obj` of global rank `src`, on every rank of `group`."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
