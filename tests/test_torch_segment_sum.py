"""The port's sorted-stream segment sum (mlease_tpu_torch.ops.segment_sum),
in its contrib form and its fused gather form, against the JAX package's
reduces on the same COO stream.

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
from mlease_tpu_torch.ops.segment_sum import (min_bytes, segment_sum_gather,
                                              segment_sum_gather_reference,
                                              segment_sum_sorted,
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


def fused_stream(seed, L, R=128, n=900):
    """A column-sorted COO stream whose ids reach both ends of V's m = R
    columns and of the S = n segments: (vals, V (L, R), idx, seg)."""
    rows, cols, vals, d = coo(seed, R=R, n=n, L=L)
    rows[:2], cols[:2] = (0, R - 1), (0, n - 1)
    order = np.argsort(cols, kind="stable")
    return (vals[order], np.ascontiguousarray(d.T), rows[order],
            cols[order])


def lane_weights(vals, L, square_from):
    """w_l(vals) as in the JAX code's where(use_sq, tv * tv, tv)."""
    return np.where(np.arange(L)[:, None] < square_from, vals[None, :],
                    (vals * vals)[None, :])


@pytest.mark.parametrize("square_from", ["none", "half"])
@pytest.mark.parametrize("L", [1, 3, 6])
def test_fused_matches_jax_reduces_of_the_same_contributions(L, square_from):
    vals, V, idx, seg = fused_stream(10 + L, L)
    n = 900
    sf = L if square_from == "none" else L // 2
    contrib = lane_weights(vals, L, sf) * V[:, idx]
    t = torch.as_tensor
    got = segment_sum_gather(t(vals), t(V), t(idx), t(seg), n,
                             square_from=sf).numpy()
    assert got[:, 0].any() and got[:, n - 1].any()

    want_plain = segment_sum_sorted_reference(t(contrib), t(seg), n).numpy()
    np.testing.assert_allclose(got, want_plain, rtol=1e-12, atol=1e-12)
    want_segsum = jax.vmap(lambda c: jax.ops.segment_sum(
        c, jnp.asarray(seg), num_segments=n, indices_are_sorted=True))(
            jnp.asarray(contrib))
    np.testing.assert_allclose(got, np.asarray(want_segsum),
                               rtol=1e-12, atol=1e-12)
    want_2level = sorted_segment_sum_2level_lanes(
        jnp.asarray(contrib), segment_offsets(jnp.asarray(seg), n))
    np.testing.assert_allclose(got, np.asarray(want_2level),
                               rtol=1e-12, atol=1e-12)
    # the contrib form of the same call squares the same lanes
    c = vals[None, :] * V[:, idx]
    got_c = segment_sum_gather(t(c), None, None, t(seg), n,
                               square_from=sf).numpy()
    want_c = segment_sum_sorted_reference(
        t(np.where(np.arange(L)[:, None] < sf, c, c * c)), t(seg), n).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("T", [0, 1, 3000])
def test_fused_accumulates_in_place_and_keeps_untouched_bits(T):
    rng = np.random.default_rng(T)
    vals, V, idx, seg = fused_stream(5, 3)
    vals, idx, seg = vals[:T], idx[:T], seg[:T]
    n = 900
    out0 = rng.normal(size=(3, n))
    out = torch.as_tensor(out0.copy())
    t = torch.as_tensor
    got = segment_sum_gather(t(vals), t(V), t(idx), t(seg), n, out=out,
                             square_from=2)
    assert got is out
    untouched = np.setdiff1d(np.arange(n), seg)
    np.testing.assert_array_equal(got.numpy()[:, untouched],
                                  out0[:, untouched])
    want = out0.copy()
    np.add.at(want.T, seg, (lane_weights(vals, 3, 2) * V[:, idx]).T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    fresh = segment_sum_gather(t(vals), t(V), t(idx), t(seg), n,
                               square_from=2).numpy()
    np.testing.assert_allclose(fresh, want - out0, rtol=1e-12, atol=1e-12)
    if T == 0:
        assert not fresh.any()


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
    # gather form: stream 5 * (8 + 8), 2 lanes of min(5, 3) V entries,
    # 2 touched outputs per lane read and written
    assert min_bytes(L=2, T=5, S=4, itemsize=8, m_hit=3, S_hit=2) == \
        5 * 16 + 2 * 3 * 8 + 2 * 2 * 2 * 8


def test_fused_wrapper_checks_and_cpu_takes_the_plain_version():
    vals = torch.ones(5, dtype=torch.float64)
    V = torch.ones((2, 3), dtype=torch.float64)
    idx = torch.tensor([0, 2, 1, 1, 0], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)
    before = segment_sum_sorted.launches
    got = segment_sum_gather(vals, V, idx, seg, 4)
    assert segment_sum_sorted.launches == before     # no kernel on the CPU
    torch.testing.assert_close(got, segment_sum_gather_reference(
        vals, V, idx, seg, 4))
    with pytest.raises(TypeError, match="int32"):
        segment_sum_gather(vals, V, idx.long(), seg, 4)
    with pytest.raises(ValueError, match="idx needs V"):
        segment_sum_gather(vals[None], None, idx, seg, 4)
    with pytest.raises(ValueError, match="expected"):
        segment_sum_gather(vals[:4], V, idx, seg, 4)
    with pytest.raises(TypeError, match="dtype"):
        segment_sum_gather(vals.float(), V, idx, seg, 4)
    with pytest.raises(ValueError, match="out must be"):
        segment_sum_gather(vals, V, idx, seg, 4, out=torch.zeros((2, 5)))
