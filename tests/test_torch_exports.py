"""The port's subpackages export what the JAX package's do (ROADMAP.md C7),
minus the names of the items still to port, and its copy of
core/partition_ids.py (A9) gives the same ids and files."""

import importlib

import pytest

from mlease_tpu.core import partition_ids as jpi
from mlease_tpu_torch.core import partition_ids as tpi

# FeatureShardedAdmmTrainer and the whole parallel package are the mesh,
# ROADMAP.md item A8
UNPORTED = {"train": {"FeatureShardedAdmmTrainer"}}


@pytest.mark.parametrize("sub", ["core", "eval", "io", "ops", "train",
                                 "utils"])
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
    with pytest.raises(ImportError):
        importlib.import_module("mlease_tpu_torch.parallel")


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
