"""The port's batched objective (mlease_tpu_torch.ops.objective) against
mlease_tpu.ops.objective, function by function, float64 on the CPU.

Three problems of one shape go through the port in one batched call and
through the JAX functions one by one. Tolerance rtol 1e-12: the two
packages add the same terms, in orders that differ only inside one sum.
Every layout branch is covered: ELL (the per-item path), the CSC dual
layout, and the hybrid dense head with a row-sorted or a column-sorted tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.ops.objective as jobj
import mlease_tpu_torch.ops.objective as tobj
from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core.dataset import csc_arrays, to_hybrid

from test_admm import synth_rows

torch.set_num_threads(1)

LAYOUTS = ["ell", "csc", "hybrid", "hybrid_col"]
P = 3


def fixture(layout, seed=5):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, 90)
    for r in rows:
        r["offset"] = float(rng.normal() * 0.3)
        r["weight"] = float(rng.uniform(0.5, 2.0))
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::P] for i in range(P)], vocab)
    n = data.dim
    pm = rng.normal(size=(P, n)) * 0.1
    pvi = rng.uniform(0.5, 4.0, size=(P, n))
    extra = {}
    if layout == "csc":
        cols, crows, vals = csc_arrays(data)
        extra = dict(csc_cols=cols, csc_rows=crows, csc_vals=vals)
    elif layout.startswith("hybrid"):
        data = to_hybrid(data, 4)
        extra = dict(head_x=data.head,
                     head_ids=np.broadcast_to(data.head_ids, (P, 4)),
                     tail_rows=data.tail_rows, tail_cols=data.tail_cols,
                     tail_vals=data.tail_vals)
        if layout == "hybrid_col":
            extra.update(tail_c_rows=data.tail_c_rows,
                         tail_c_cols=data.tail_c_cols,
                         tail_c_vals=data.tail_c_vals)
    base = dict(indices=data.indices, values=data.values, y=data.y,
                weight=data.weight, offset=data.offset, prior_mean=pm,
                prior_var_inv=pvi, **extra)

    def as_jax(v):
        v = np.asarray(v)
        return jnp.asarray(v if v.dtype.kind in "iu" else
                           v.astype(np.float64))

    def as_torch(v):
        v = np.asarray(v)
        return torch.as_tensor(v.astype(np.int64 if v.dtype.kind in "iu"
                                        else np.float64))

    jprobs = [jobj.LRProblem(**{k: as_jax(v[p]) for k, v in base.items()})
              for p in range(P)]
    tprob = tobj.LRProblem(**{k: as_torch(v) for k, v in base.items()})
    W = rng.normal(size=(P, n)) * 0.3
    D = rng.random(size=(P, data.y.shape[1]))
    return jprobs, tprob, W, D


def per_problem(fn, jprobs, *args):
    """The JAX function on each problem; tuple outputs stay tuples."""
    outs = [fn(p, *[jnp.asarray(a[i]) for a in args])
            for i, p in enumerate(jprobs)]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[k]) for o in outs])
                     for k in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


CASES = {
    "xv": ("W",), "xtv": ("D",), "scores": ("W",), "fun": ("W",),
    "grad_and_curvature": ("W",), "grad": ("W",), "hv": ("D", "W"),
    "hessian_diagonal": ("W",), "densify": (), "dense_hessian": ("W",),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax(name, layout):
    jprobs, tprob, W, D = fixture(layout)
    args = [{"W": W, "D": D}[a] for a in CASES[name]]
    want = per_problem(getattr(jobj, name), jprobs, *args)
    got = getattr(tobj, name)(tprob, *[torch.as_tensor(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-13)


def test_make_problem_from_a_block_and_from_blocked_data():
    rng = np.random.default_rng(2)
    rows = synth_rows(rng, 40)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[:20], rows[20:]], vocab)
    n = data.dim
    pm, pvi = np.zeros((2, n)), np.ones((2, n))
    batched = tobj.make_problem(data, pm, pvi, positive_weight=2.0,
                                dtype=torch.float64, device="cpu")
    from mlease_tpu.core.dataset import Block
    singles = []
    for b in range(2):
        blk = Block(data.indices[b], data.values[b], data.y[b],
                    data.weight[b], data.offset[b], int(data.nrows[b]))
        singles.append(tobj.make_problem(blk, pm[b], pvi[b],
                                         positive_weight=2.0,
                                         dtype=torch.float64, device="cpu"))
        want = jobj.make_problem(blk, pm[b], pvi[b], positive_weight=2.0,
                                 dtype=jnp.float64)
        np.testing.assert_array_equal(singles[-1].weight[0].numpy(),
                                      np.asarray(want.weight))
    for k in ("indices", "values", "y", "weight", "offset", "prior_mean"):
        stacked = torch.cat([getattr(p, k) for p in singles])
        torch.testing.assert_close(stacked, getattr(batched, k),
                                   rtol=0, atol=0)
    assert batched.dim == n and batched.csc_cols is None
    # the constructor defaults to the card and does not give way to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tobj.make_problem(data, pm, pvi)


def test_class_balance_eps_scale_matches_jax():
    rng = np.random.default_rng(3)
    y = np.where(rng.random((4, 12)) < 0.3, 1.0, -1.0)
    nrows = np.array([12, 7, 0, 3])
    np.testing.assert_array_equal(tobj.class_balance_eps_scale(y, nrows),
                                  jobj.class_balance_eps_scale(y, nrows))


def sorted_streams_problem(rng, dtype, B=3, R=11, n=7, T=40):
    """An LRProblem of B blocks (R rows, n columns) carrying the three
    sorted streams (the column-sorted copy, the row-sorted and the
    column-sorted tails), random ids and values, float64 or bfloat16."""
    def stream(seg_w, idx_w):
        return (torch.as_tensor(np.sort(rng.integers(0, seg_w, (B, T)), 1)),
                torch.as_tensor(rng.integers(0, idx_w, (B, T))),
                torch.as_tensor(rng.normal(size=(B, T))).to(dtype))
    csc, tail, tail_c = stream(n, R), stream(R, n), stream(n, R)
    z = torch.zeros((B, R), dtype=dtype)
    return tobj.LRProblem(
        indices=torch.zeros((B, R, 0), dtype=torch.long),
        values=torch.zeros((B, R, 0), dtype=dtype), y=z, weight=z, offset=z,
        prior_mean=None, prior_var_inv=None,
        csc_cols=csc[0], csc_rows=csc[1], csc_vals=csc[2],
        tail_rows=tail[0], tail_cols=tail[1], tail_vals=tail[2],
        tail_c_cols=tail_c[0], tail_c_rows=tail_c[1], tail_c_vals=tail_c[2])


@pytest.mark.parametrize("per", [None, 2, 1], ids=["one-call", "by-2", "by-1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k1_sorted_sum_matches_the_scatter(monkeypatch, per, dtype):
    """The card's route of the lanes objective's sorted sums (K1 over the
    blocks stacked, one call per sub-stack that fits int32, on the ids
    objective.k1_streams makes once), here through K1's plain version on
    the CPU, against the CPU's batched scatter_add_, for each of the three
    streams: to 1e-12 in float64 (the sums' order differs), to 1e-6 of the
    sums' magnitude for a bfloat16 stream (float32 products and sums both
    ways); blocks stacked in one call, or, with the bound lowered, in
    sub-stacks of 2 and 1 (the out written back into a strided slice)."""
    from mlease_tpu_torch.ops import objective, tron_multi
    rng = np.random.default_rng(3)
    L, B, R, n = 3, 3, 11, 7
    if per is not None:
        monkeypatch.setattr(tron_multi, "STACK_ID_BOUND",
                            per * max(R, n) + 1)
    prob = sorted_streams_problem(rng, dtype, B, R, n)
    ranges = tron_multi.substack_ranges(B, n, R)
    assert len(ranges) == (1 if per is None else -(-B // per))
    k1 = objective.k1_streams(prob, n, ranges)
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    for stream, (W, m) in {"csc": (n, R), "tail": (R, n),
                           "tail_c": (n, R)}.items():
        vals = getattr(prob, objective._STREAMS[stream][2])
        V3 = torch.as_tensor(rng.normal(size=(L, B, m))).to(acc)
        out0 = torch.as_tensor(rng.normal(size=(L, B, W))).to(acc)
        want = objective._sorted_sum(prob, stream, out0.clone(), V3)
        got = objective._k1_sorted_sum(out0.clone(), getattr(k1, stream),
                                       vals, V3, k1.ranges)
        absprob = prob._replace(**{objective._STREAMS[stream][2]:
                                   vals.abs().to(acc)})
        scale = objective._sorted_sum(absprob, stream, out0.abs(), V3.abs())
        tol = 1e-12 if dtype == torch.float64 else 1e-6
        assert bool(((got - want).abs() <= tol * scale).all()), stream


@pytest.mark.parametrize("per", [None, 1], ids=["one-call", "by-1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_k1_sorted_sum_squares_like_the_scatter(monkeypatch, per, dtype):
    """The Hessian diagonal's sorted sum (square=True: K1 squares the
    values itself, square_from 0), through K1's plain version on the CPU,
    against the CPU's scatter of the squared values, for the column-sorted
    copy the item problems carry: to 1e-12 in float64, to 1e-6 of the
    sums' magnitude for a bfloat16 stream (the square formed in float32
    both ways)."""
    from mlease_tpu_torch.ops import objective, tron_multi
    rng = np.random.default_rng(4)
    L, B, R, n = 2, 3, 11, 7
    if per is not None:
        monkeypatch.setattr(tron_multi, "STACK_ID_BOUND",
                            per * max(R, n) + 1)
    prob = sorted_streams_problem(rng, dtype, B, R, n)
    k1 = objective.k1_streams(prob, n, tron_multi.substack_ranges(B, n, R))
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    V3 = torch.as_tensor(rng.uniform(0.0, 0.25, size=(L, B, R))).to(acc)
    out0 = torch.as_tensor(rng.uniform(0.5, 4.0, size=(L, B, n))).to(acc)
    want = objective._sorted_sum(prob, "csc", out0.clone(), V3, square=True)
    got = objective._k1_sorted_sum(out0.clone(), k1.csc, prob.csc_vals, V3,
                                   k1.ranges, square=True)
    plain = objective._sorted_sum(prob, "csc", out0.clone(), V3)
    assert not torch.allclose(want, plain)      # the square is taken
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert bool(((got - want).abs() <= tol * want.abs()).all())


def test_stacked_k1_ids_are_the_blocked_ones():
    """A streamed group's K1 ids (train/admm.py::stacked_k1, the stacked
    int32 ids as they ship, the column-sorted copy made from the shipped
    column order of train/streaming.py::_column_order) equal the ids
    blocked_problem makes from the per-block arrays (objective.k1_streams
    over one range), and unstack_problem's column-sorted copy is
    objective.column_sorted's, entry for entry."""
    from mlease_tpu_torch.core import build_vocab as tbuild_vocab
    from mlease_tpu_torch.core.dataset import pack_blocks as tpack_blocks
    from mlease_tpu_torch.core.dataset import to_hybrid as tto_hybrid
    from mlease_tpu_torch.ops.tron_multi import stack_blocks
    from mlease_tpu_torch.train.admm import stacked_k1, unstack_problem
    from mlease_tpu_torch.train.streaming import _column_order
    rows = synth_rows(np.random.default_rng(5), 120)
    vocab = tbuild_vocab(rows)
    for head_size in (0, 4):
        data = tpack_blocks([rows[i::3] for i in range(3)], vocab)
        if head_size:
            data = tto_hybrid(data, head_size, column_sorted=True)
        B, R, n = data.nblocks, data.padded_rows, data.dim
        t = (lambda a: None if a is None else torch.as_tensor(np.asarray(a)))
        head = (None,) * 8 if data.head is None else tuple(t(a) for a in (
            data.head, data.head_ids, data.tail_rows, data.tail_cols,
            data.tail_vals, data.tail_c_rows, data.tail_c_cols,
            data.tail_c_vals))
        arrays = (t(data.indices), t(data.values), t(data.y), t(data.weight),
                  t(data.offset), head)
        stacked = stack_blocks(*arrays, torch.zeros((1, B, n),
                                                    dtype=torch.float64),
                               torch.ones(1, dtype=torch.float64))
        perm = None
        if data.indices.shape[2] > 0:
            offs = (np.arange(B)[:, None, None] * n).astype(np.int32)
            perm = _column_order(np.asarray(data.indices) + offs, [(0, B)])
        lanes = unstack_problem(stacked, B, n, torch.float64, perm)
        csc = None
        if perm is not None:
            for got, want in zip((lanes.csc_cols, lanes.csc_rows,
                                  lanes.csc_vals),
                                 tobj.column_sorted(arrays[0], arrays[1])):
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            K = stacked.indices.shape[-1]
            csc = (stacked.indices.reshape(-1).index_select(0, perm),
                   perm // K, None)
        got = stacked_k1(stacked, B, csc)
        want = tobj.k1_streams(lanes, n, [(0, B)])
        assert got.ranges == want.ranges == ((0, B),)
        for f in ("csc", "tail", "tail_c"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            for a, b in zip(g or (), w or ()):
                assert a.dtype == b.dtype == torch.int32
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_column_sorted_is_the_dual_layout():
    """The card's device-made column-sorted copy (objective.column_sorted)
    is core/dataset.py::csc_arrays's dual layout, entry for entry."""
    from mlease_tpu_torch.core import build_vocab as tbuild_vocab
    from mlease_tpu_torch.core.dataset import csc_arrays as tcsc_arrays
    from mlease_tpu_torch.core.dataset import pack_blocks as tpack_blocks
    rows = synth_rows(np.random.default_rng(5), 120)
    vocab = tbuild_vocab(rows)
    data = tpack_blocks([rows[i::3] for i in range(3)], vocab)
    got = tobj.column_sorted(torch.as_tensor(data.indices),
                             torch.as_tensor(data.values))
    for g, w in zip(got, tcsc_arrays(data)):
        np.testing.assert_array_equal(g.numpy(), w)
