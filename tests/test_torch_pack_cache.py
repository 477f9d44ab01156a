"""The port's pack cache (mlease_tpu_torch/io/pack_cache.py) against the JAX
package's: the same manifest, and a cache written by either package loads
in the other with the same bits, bfloat16 heads included (the JAX package
holds them as ml_dtypes arrays, the port as torch.bfloat16 tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mlease_tpu.io.pack_cache as jpc
import mlease_tpu_torch.io.pack_cache as tpc
from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core.dataset import split_blocks as jsplit
from mlease_tpu.core.dataset import to_hybrid as jto_hybrid
from mlease_tpu_torch.core.dataset import to_hybrid as tto_hybrid

from test_admm import synth_rows

torch.set_num_threads(1)

FIELDS = ("indices", "values", "y", "weight", "offset", "present", "nrows",
          "head", "head_ids", "tail_rows", "tail_cols", "tail_vals",
          "tail_c_rows", "tail_c_cols", "tail_c_vals")


def bits(a):
    """An array's raw bits as numpy (bfloat16 of either package as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    if a.dtype == np.dtype(jnp.bfloat16):
        return a.view(np.uint16)
    return a


def assert_same_groups(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.nblocks, g.dim) == (w.nblocks, w.dim)
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                a, b = bits(a), bits(b)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    rows = synth_rows(rng, 360)
    vocab = build_vocab(rows)
    return pack_blocks([rows[i::6] for i in range(6)], vocab), vocab


def manifest_kwargs(files, **kw):
    base = dict(nblocks=6, n_groups=3, head_size=4, head_dtype="bfloat16",
                num_click_replicates=1, seed=0, binary_feature=False,
                map_key="")
    base.update(kw)
    return base


def test_manifests_and_dtype_names_equal(tmp_path):
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"part-{i}.avro"))
        open(files[-1], "wb").write(b"x" * (i + 1))
    for kw in ({}, {"map_key": "item", "binary_feature": True}):
        assert tpc.build_manifest(files, **manifest_kwargs(files, **kw)) == \
            jpc.build_manifest(files, **manifest_kwargs(files, **kw))
    for t, j in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
                 (torch.float64, jnp.float64)):
        assert tpc.dtype_name(t) == str(np.dtype(j))


def test_hybrid_bf16_heads_equal_jax(data):
    blocked, _vocab = data
    for g in jsplit(blocked, 3):
        j = jto_hybrid(g, 4, column_sorted=True, head_dtype=jnp.bfloat16)
        t = tto_hybrid(g, 4, column_sorted=True, head_dtype=torch.bfloat16)
        assert isinstance(t.head, torch.Tensor)
        assert_same_groups([t], [j])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_written_by_one_package_loads_in_the_other(tmp_path, data,
                                                         writer):
    blocked, vocab = data
    src = tmp_path / "in.avro"
    src.write_bytes(b"data")
    groups_j = [jto_hybrid(g, 4, column_sorted=True, head_dtype=jnp.bfloat16)
                for g in jsplit(blocked, 3)]
    groups_t = [tto_hybrid(g, 4, column_sorted=True,
                           head_dtype=torch.bfloat16)
                for g in jsplit(blocked, 3)]
    manifest = jpc.build_manifest([str(src)], **manifest_kwargs([]))
    cache = str(tmp_path / "cache")
    if writer == "jax":
        jpc.save_groups(cache, manifest, groups_j, vocab)
        loaded, lvocab = tpc.load_groups(cache, manifest)
        assert isinstance(loaded[0].head, torch.Tensor)
        assert loaded[0].head.dtype == torch.bfloat16
    else:
        tpc.save_groups(cache, manifest, groups_t, vocab)
        loaded, lvocab = jpc.load_groups(cache, manifest)
        assert loaded[0].head.dtype == np.dtype(jnp.bfloat16)
    assert lvocab.names == vocab.names
    assert_same_groups(loaded, groups_j)
    assert_same_groups(loaded, groups_t)
    # and each package reads its own cache back the same
    own = (jpc if writer == "jax" else tpc).load_groups(cache, manifest)[0]
    assert_same_groups(own, groups_j)


def test_changed_knob_or_input_misses(tmp_path, data):
    blocked, vocab = data
    src = tmp_path / "in.avro"
    src.write_bytes(b"data")
    groups = [tto_hybrid(g, 4, head_dtype=torch.bfloat16)
              for g in jsplit(blocked, 3)]
    manifest = tpc.build_manifest([str(src)], **manifest_kwargs([]))
    cache = str(tmp_path / "cache")
    tpc.save_groups(cache, manifest, groups, vocab)
    assert tpc.load_groups(cache, manifest) is not None
    for kw in ({"head_size": 8}, {"head_dtype": "float32"}, {"seed": 1},
               {"n_groups": 2}, {"map_key": "k"}):
        changed = tpc.build_manifest([str(src)], **manifest_kwargs([], **kw))
        assert tpc.load_groups(cache, changed) is None, kw
    src.write_bytes(b"longer data")            # the input changed size
    assert tpc.load_groups(cache, tpc.build_manifest(
        [str(src)], **manifest_kwargs([]))) is None
    # a truncated group file rebuilds instead of failing the job
    (tmp_path / "cache" / "group-1.npz").write_bytes(b"PK")
    assert tpc.load_groups(cache, manifest) is None
