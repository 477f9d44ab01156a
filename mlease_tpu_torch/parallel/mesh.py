"""Device mesh + block layout for the consensus trainer, on torch.distributed.

Port of mlease_tpu/parallel/mesh.py. The JAX package replaces the
reference's distribution substrate (Hadoop shuffle partitioning,
DistributedCache broadcast, the driver-side meanModel reduce; reference:
src/main/java/com/linkedin/mapred/*, RegressionAdmmTrain.java:352-364) with
one controller that shards arrays over many devices. The port runs the
PyTorch idiom instead, one process per rank with every rank running the
same driver (SPMD), the shape of the JAX package's multi-host path
(parallel/distributed.py):

  * the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks
    of the process group, dimension "block" (1-D) or ("block", "feat")
    (2-D, feat innermost);
  * every rank holds the whole host data, pads the block axis to a multiple
    of the block dimension (`pad_blocks`) and keeps its own contiguous range
    of blocks (`block_sharding(...).take`); z is replicated, u lives with
    its blocks;
  * the block mean of the ADMM step is one all_reduce over the block group
    per iteration; padded blocks are masked out of it.

The backend follows the device (NCCL for cuda, gloo for cpu; see
distributed.initialize). Every collective goes through
mlease_tpu_torch/collectives.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mlease_tpu_torch.core.dataset import BlockedData
from mlease_tpu_torch.device import resolve_device

BLOCK_AXIS = "block"
FEAT_AXIS = "feat"

LAUNCH_HINT = ("python -m torch.distributed.run --nproc-per-node {n} "
               "-m mlease_tpu_torch train --mesh {n} ...")


def _world_size(n=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a process group: start the ranks with "
            + LAUNCH_HINT.format(n=n or "N")
            + " or call mlease_tpu_torch.parallel.distributed.initialize"
            "(init_method=..., world_size=..., rank=...) first")
    return dist.get_world_size()


def make_mesh(n: int | None = None, device: str | torch.device = "cuda"):
    """1-D ("block",) mesh over every rank of the process group. `n` must
    equal the world size (0 or None: all ranks)."""
    dev = resolve_device(device)
    world = _world_size(n)
    if n and int(n) != world:
        raise ValueError(
            f"a mesh of {n} ranks needs a process group of {n} ranks; this "
            f"one has {world} (start them with "
            f"{LAUNCH_HINT.format(n=n)})")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(BLOCK_AXIS,))


def make_mesh_2d(block: int = 1, feat: int = 1,
                 device: str | torch.device = "cuda"):
    """2-D (block, feat) mesh: data parallelism over blocks x feature model
    parallelism over column shards (train/feature_sharded.py), feat
    innermost (rank = b * feat + s). Ranks past block * feat hold no place
    in it (get_coordinate() is None): they sit out the solve and receive
    the result by broadcast, as the JAX package leaves trailing devices
    idle. Every rank of the group must call this."""
    dev = resolve_device(device)
    world = _world_size()
    need = int(block) * int(feat)
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(need).reshape(block, feat),
                      mesh_dim_names=(BLOCK_AXIS, FEAT_AXIS))


def mesh_device(mesh) -> torch.device:
    """The torch device this rank's part of `mesh` runs on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str = BLOCK_AXIS) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str = BLOCK_AXIS) -> int:
    """This rank's coordinate along `axis` (the mesh must hold the rank)."""
    return int(mesh.get_local_rank(axis))


class Sharding(NamedTuple):
    """Which part of an array this rank holds: the `index`-th of `parts`
    equal contiguous slices along `axis`, or the whole array (axis None)."""

    axis: int | None
    index: int = 0
    parts: int = 1

    def take(self, a):
        """This rank's part of a numpy array or tensor (a view)."""
        if a is None or self.axis is None:
            return a
        size = a.shape[self.axis]
        if size % self.parts:
            raise ValueError(f"axis {self.axis} of length {size} does not "
                             f"divide over {self.parts} ranks (pad_blocks)")
        per = size // self.parts
        sl = [slice(None)] * self.axis + [
            slice(self.index * per, (self.index + 1) * per)]
        return a[tuple(sl)]


def block_sharding(mesh, extra_leading_dims: int = 0) -> Sharding:
    """The layout of arrays whose axis `extra_leading_dims` is the block
    axis (0 for data arrays (B, ...), 1 for duals (L, B, ...)): this rank
    holds its block coordinate's slice."""
    return Sharding(extra_leading_dims, axis_index(mesh, BLOCK_AXIS),
                    axis_size(mesh, BLOCK_AXIS))


def replicated(mesh) -> Sharding:
    return Sharding(None)


def pad_blocks(data: BlockedData, multiple: int) -> tuple[BlockedData, np.ndarray]:
    """Pad the block axis to a multiple of the mesh size with empty blocks.

    Returns (padded_data, block_valid) where block_valid is (B_padded,) with
    1.0 for real blocks. Padded blocks have zero weight and all-false presence,
    so with the valid-mask consensus mean they are exact no-ops. (A copy of
    the JAX package's numpy function.)
    """
    B = data.nblocks
    B_pad = ((B + multiple - 1) // multiple) * multiple
    valid = np.zeros(B_pad, dtype=np.float64)
    valid[:B] = 1.0
    if B_pad == B:
        return data, valid

    def pad(a):
        pad_width = [(0, B_pad - B)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, pad_width)

    return BlockedData(
        indices=pad(data.indices), values=pad(data.values),
        y=np.pad(data.y, [(0, B_pad - B), (0, 0)], constant_values=1.0),
        weight=pad(data.weight), offset=pad(data.offset),
        present=pad(data.present), nrows=pad(data.nrows),
        nblocks=B_pad, dim=data.dim,
        head=None if data.head is None else _pad_head(data.head, B_pad - B),
        head_ids=data.head_ids,
        tail_rows=None if data.tail_rows is None else pad(data.tail_rows),
        tail_cols=None if data.tail_cols is None else pad(data.tail_cols),
        tail_vals=None if data.tail_vals is None else pad(data.tail_vals),
        tail_c_rows=None if data.tail_c_rows is None else pad(data.tail_c_rows),
        tail_c_cols=None if data.tail_c_cols is None else pad(data.tail_c_cols),
        tail_c_vals=None if data.tail_c_vals is None else pad(data.tail_c_vals),
    ), valid


def _pad_head(head, extra: int):
    """The dense head with `extra` zero blocks appended: a numpy array, or
    a host torch.bfloat16 tensor (head.dtype=bfloat16)."""
    if isinstance(head, torch.Tensor):
        return torch.cat([head, head.new_zeros((extra, *head.shape[1:]))])
    return np.pad(head, [(0, extra)] + [(0, 0)] * (head.ndim - 1))


_BLOCK_FIELDS = ("indices", "values", "y", "weight", "offset", "present",
                 "nrows", "head", "tail_rows", "tail_cols", "tail_vals",
                 "tail_c_rows", "tail_c_cols", "tail_c_vals")


def local_blocks(mesh, data: BlockedData) -> tuple[BlockedData, np.ndarray]:
    """This rank's share of `data`: the block axis padded to a multiple of
    the mesh's block dimension (pad_blocks), then the rank's contiguous
    range of blocks (views). Returns (local data, its (B_local,) bool mask
    of real blocks)."""
    data, valid = pad_blocks(data, axis_size(mesh, BLOCK_AXIS))
    sh = block_sharding(mesh, 0)
    return data._replace(nblocks=data.nblocks // sh.parts, **{
        f: sh.take(getattr(data, f)) for f in _BLOCK_FIELDS}), \
        sh.take(valid) > 0


def shard_blocked_arrays(mesh, arrays: dict) -> dict:
    """This rank's part of a dict of named arrays in the standard ADMM
    layout: 'indices','values','y','weight','offset','present','eps',
    'block_valid','head' split on axis 0; 'u' on axis 1; everything else
    whole. Numpy arrays and tensors are sliced where they lie (views)."""
    data_sharded = {"indices", "values", "y", "weight", "offset", "present",
                    "eps", "block_valid", "head"}
    out = {}
    for name, arr in arrays.items():
        if name in data_sharded:
            sh = block_sharding(mesh, 0)
        elif name == "u":
            sh = block_sharding(mesh, 1)
        else:
            sh = replicated(mesh)
        out[name] = sh.take(arr)
    return out
