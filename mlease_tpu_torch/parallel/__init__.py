from mlease_tpu_torch.parallel.mesh import (
    BLOCK_AXIS,
    block_sharding,
    make_mesh,
    pad_blocks,
    replicated,
    shard_blocked_arrays,
)

# cpu_devices (the JAX package's list of XLA host devices for a virtual
# multi-device mesh) has no torch counterpart: a CPU mesh here is gloo
# ranks, one process each (parallel/distributed.py)
__all__ = [
    "BLOCK_AXIS", "block_sharding", "make_mesh",
    "pad_blocks", "replicated", "shard_blocked_arrays",
]
