"""Process-group initialization + mesh construction across ranks and hosts.

Port of mlease_tpu/parallel/distributed.py. The reference scales across
machines via the Hadoop job tracker; the JAX package runs a `jax.distributed`
SPMD job; the port runs a torch.distributed one: every rank runs the same
driver, `initialize()` wires the process group, and the 1-D block mesh
spans every rank, so the consensus all_reduce crosses NVLink within a host
and the network across hosts with no trainer change (the trainer only sees
a bigger mesh).

Usage on each rank (`python -m torch.distributed.run` sets RANK,
WORLD_SIZE and MASTER_ADDR/PORT, which `initialize()` reads):

    from mlease_tpu_torch.parallel import distributed
    distributed.initialize()                  # under torchrun, or
    distributed.initialize(init_method="tcp://host0:1234",
                           world_size=4, rank=i)
    mesh = distributed.global_mesh()
    trainer = AdmmTrainer(data, vocab, cfg, mesh=mesh)

The backend follows the device (NCCL for cuda, gloo for cpu) unless the
caller names one: `initialize(backend="gloo", ...)` runs several ranks on
one card (NCCL refuses two ranks on one device; gloo stages the card's
tensors through host memory). Nothing falls back from one backend to the
other.

`host_block_range(nblocks)` says which consensus blocks this rank should
pack; `make_global_blocked_arrays` puts them on the rank's device and
checks that the ranks' ranges cover the global block count.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.collectives import all_reduce
from mlease_tpu_torch.parallel.mesh import BLOCK_AXIS, make_mesh, mesh_device


def _under_launcher() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(device: str | torch.device = "cuda", **kwargs) -> None:
    """torch.distributed.init_process_group passthrough: a no-op in a single
    process with no arguments (no launcher variables) or when a group
    exists. Under a launcher it reads RANK / WORLD_SIZE / MASTER_* (the
    env:// init method). backend defaults to NCCL for a cuda device, gloo
    for the CPU; on the card each rank takes LOCAL_RANK modulo the visible
    devices."""
    if dist.is_initialized() or not (kwargs or _under_launcher()):
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def initialize_single(device: str | torch.device = "cuda") -> None:
    """A one-rank process group (the backend following the device) over
    an in-memory store, for a mesh of one rank outside a launcher; a no-op
    when a group exists."""
    if dist.is_initialized():
        return
    initialize(device, store=dist.HashStore(), world_size=1, rank=0)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on the rank that writes files: rank 0, or a lone process."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def global_mesh(device: str | torch.device = "cuda"):
    """1-D block mesh over every rank (all hosts)."""
    return make_mesh(None, device)


def host_block_range(nblocks: int) -> tuple[int, int]:
    """[start, end) of consensus blocks this rank should load, the blocks
    distributed contiguously over the ranks (block axis order = rank
    order)."""
    p, n = rank(), world_size()
    per = (nblocks + n - 1) // n
    return p * per, min((p + 1) * per, nblocks)


def make_global_blocked_arrays(mesh, local_arrays: dict,
                               global_nblocks: int) -> dict:
    """This rank's block shards (host arrays from host_block_range) as
    tensors on the mesh's device; "u" carries its blocks on axis 1, every
    other array on axis 0. One all_reduce over the block group checks that
    the ranks' shards add up to global_nblocks."""
    dev = mesh_device(mesh)
    out, local_b = {}, None
    for name, arr in local_arrays.items():
        axis = 1 if name == "u" else 0
        b = np.shape(arr)[axis]
        if local_b is not None and b != local_b:
            raise ValueError(f"{name} holds {b} blocks, not {local_b}")
        local_b = b
        out[name] = torch.as_tensor(np.asarray(arr), device=dev)
    count = torch.tensor([float(local_b or 0)], dtype=torch.float64,
                         device=dev)
    all_reduce(count, "sum", mesh.get_group(BLOCK_AXIS))
    if int(count.item()) != int(global_nblocks):
        raise ValueError(f"the ranks hold {int(count.item())} blocks in all, "
                         f"not {global_nblocks}")
    return out

