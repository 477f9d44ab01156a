"""The port's subpackages export what the JAX package's do (ROADMAP.md C7),
minus the names that have no counterpart in the port, and its copy of
core/partition_ids.py (A9) gives the same ids and files."""

import importlib

import pytest

from mlease_tpu.core import partition_ids as jpi
from mlease_tpu_torch.core import partition_ids as tpi

# cpu_devices lists the XLA host devices of a virtual multi-device mesh; a
# CPU mesh of the port is gloo ranks, one process each (no device list)
UNPORTED = {"parallel": {"cpu_devices"}}


@pytest.mark.parametrize("sub", ["core", "eval", "io", "ops", "parallel",
                                 "train", "utils"])
def test_subpackage_all_matches_jax(sub):
    jax_mod = importlib.import_module(f"mlease_tpu.{sub}")
    port = importlib.import_module(f"mlease_tpu_torch.{sub}")
    assert port.__all__ == [n for n in jax_mod.__all__
                            if n not in UNPORTED.get(sub, set())]
    for name in port.__all__:
        obj = getattr(port, name)
        where = getattr(obj, "__module__", None) or getattr(obj, "__name__",
                                                            "")
        if where:
            assert where.startswith("mlease_tpu_torch"), (name, where)


def test_parallel_is_not_ported():
    """What of the JAX package's parallel/ is not ported: cpu_devices
    alone; its modules and every other name are (the mesh, A8)."""
    import mlease_tpu.parallel as jpar
    port = importlib.import_module("mlease_tpu_torch.parallel")
    assert not hasattr(port, "cpu_devices")
    assert set(jpar.__all__) - set(port.__all__) == {"cpu_devices"}
    from mlease_tpu.parallel import distributed as jdist
    from mlease_tpu.parallel import mesh as jmesh
    from mlease_tpu_torch.parallel import distributed as tdist
    from mlease_tpu_torch.parallel import mesh as tmesh
    for name in ("initialize", "global_mesh", "host_block_range",
                 "make_global_blocked_arrays"):
        assert callable(getattr(jdist, name)) and callable(getattr(tdist,
                                                                   name))
    for name in ("BLOCK_AXIS", "FEAT_AXIS", "make_mesh", "make_mesh_2d",
                 "block_sharding", "replicated", "pad_blocks",
                 "shard_blocked_arrays"):
        assert hasattr(jmesh, name) and hasattr(tmesh, name), name
    assert (tmesh.BLOCK_AXIS, tmesh.FEAT_AXIS) == (jmesh.BLOCK_AXIS,
                                                   jmesh.FEAT_AXIS)


@pytest.mark.parametrize("lambdas", [None, [1.0, 0.5, 1e-4, 12345678.0]])
def test_partition_ids_match_jax(tmp_path, lambdas):
    keys = ["item9", "item10", "a", "a", "b#c", ""]
    want = jpi.assign_partition_ids(keys, lambdas)
    got = tpi.assign_partition_ids(keys, lambdas)
    assert got == want and list(got) == list(want)
    tpi.write_partition_ids(str(tmp_path / "t.avro"), got)
    jpi.write_partition_ids(str(tmp_path / "j.avro"), want)
    assert (tmp_path / "t.avro").read_bytes() == \
        (tmp_path / "j.avro").read_bytes()
    assert tpi.read_partition_ids(str(tmp_path / "j.avro")) == want
    assert jpi.read_partition_ids(str(tmp_path / "t.avro")) == got
