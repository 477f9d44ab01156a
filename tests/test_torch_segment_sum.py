"""The port's sorted-stream segment sum (mlease_tpu_torch.ops.segment_sum)
against the JAX package's reduces on the same COO stream.

On the CPU the wrapper runs its plain version; the kernel itself is held
against that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerances: float32 to atol 1e-4 against the TPU kernel's
interpret run, as tests/test_kernels.py holds that kernel; float64 to rtol
1e-12 against the other reduces, which add the same terms in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.ops.pallas.tile_sum import (TILE_C, segment_layout,
                                            tile_segment_sum)
from mlease_tpu.ops.segsum import (segment_offsets,
                                   sorted_segment_sum_2level_lanes)
from mlease_tpu_torch.ops.segment_sum import (min_bytes, segment_sum_sorted,
                                              segment_sum_sorted_reference)

torch.set_num_threads(1)


def coo(seed, T=3000, R=128, n=900, L=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, T).astype(np.int32)
    cols = rng.integers(0, n, T).astype(np.int32)
    vals = rng.normal(size=T).astype(dtype)
    d = rng.normal(size=(R, L)).astype(dtype)
    return rows, cols, vals, d


def sorted_stream(cols, vals, rows, d):
    """Column-sorted (L, T) contributions vals * d[rows] and their ids."""
    order = np.argsort(cols, kind="stable")
    contrib = (vals[:, None] * d[rows])[order].T
    return np.ascontiguousarray(contrib), cols[order]


def port(contrib, seg, S):
    return segment_sum_sorted(torch.as_tensor(contrib),
                              torch.as_tensor(seg), S).numpy()


def test_matches_tpu_tile_segment_sum_interpret():
    rows, cols, vals, d = coo(0, dtype=np.float32)
    n = 900
    order, slot, local, C, P = segment_layout(cols, n)
    slab = np.zeros((C * P, 3), np.float32)
    slab[slot] = (vals[:, None] * d[rows])[order]
    want = tile_segment_sum(jnp.asarray(slab.reshape(C, P, 3)),
                            jnp.asarray(local), C, P, interpret=True)
    assert want.shape == (C * TILE_C, 3)
    contrib, seg = sorted_stream(cols, vals, rows, d)
    got = port(contrib, seg, n)
    np.testing.assert_allclose(got.T, np.asarray(want)[:n], atol=1e-4)


@pytest.mark.parametrize("L", [1, 3, 6])
def test_matches_jax_reduces_and_f64_add_at(L):
    rows, cols, vals, d = coo(L, L=L)
    n = 900
    contrib, seg = sorted_stream(cols, vals, rows, d)
    got = port(contrib, seg, n)

    want_add_at = np.zeros((L, n))
    np.add.at(want_add_at.T, cols, vals[:, None] * d[rows])
    np.testing.assert_allclose(got, want_add_at, rtol=1e-12, atol=1e-13)

    want_segsum = jax.vmap(lambda c: jax.ops.segment_sum(
        c, jnp.asarray(seg), num_segments=n, indices_are_sorted=True))(
            jnp.asarray(contrib))
    np.testing.assert_allclose(got, np.asarray(want_segsum),
                               rtol=1e-12, atol=1e-13)

    offsets = segment_offsets(jnp.asarray(seg), n)
    want_2level = sorted_segment_sum_2level_lanes(jnp.asarray(contrib),
                                                  offsets)
    np.testing.assert_allclose(got, np.asarray(want_2level),
                               rtol=1e-12, atol=1e-12)


def test_empty_segments_are_exact_zero():
    rng = np.random.default_rng(3)
    S = 500
    used = np.sort(rng.choice(S, 40, replace=False))
    seg = np.sort(rng.choice(used, 2000)).astype(np.int32)
    contrib = rng.normal(size=(3, seg.size))
    got = port(contrib, seg, S)
    empty = np.setdiff1d(np.arange(S), seg)
    assert empty.size > 0
    assert np.all(got[:, empty] == 0.0)
    want = np.zeros((3, S))
    np.add.at(want.T, seg, contrib.T)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_one_segment_holds_the_whole_stream():
    rng = np.random.default_rng(4)
    contrib = rng.normal(size=(6, 10_000))
    seg = np.full(10_000, 7, np.int32)
    got = port(contrib, seg, 9)
    np.testing.assert_allclose(got[:, 7], contrib.sum(1), rtol=1e-12)
    assert np.all(np.delete(got, 7, axis=1) == 0.0)


def test_wrapper_checks_and_cpu_takes_the_plain_version():
    contrib = torch.ones((2, 5), dtype=torch.float64)
    seg = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)
    before = segment_sum_sorted.launches
    got = segment_sum_sorted(contrib, seg, 4)
    assert segment_sum_sorted.launches == before     # no kernel on the CPU
    torch.testing.assert_close(got, segment_sum_sorted_reference(
        contrib, seg, 4))
    with pytest.raises(TypeError, match="int32"):
        segment_sum_sorted(contrib, seg.long(), 4)
    with pytest.raises(ValueError, match="expected"):
        segment_sum_sorted(contrib, seg[:4], 4)
    assert min_bytes(L=2, T=5, S=4, itemsize=8) == (10 + 8) * 8 + 20
