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
