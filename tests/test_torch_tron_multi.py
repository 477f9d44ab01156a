"""The port's multi-RHS TRON (mlease_tpu_torch.ops.tron_multi) against the
JAX package's, on the fixtures of tests/test_tron_multi.py, float64 on the
CPU.

Tolerances: the lanes-major passes agree to rtol 1e-12 (the two packages
add the same terms in orders that differ only inside one sum: XLA's and
torch's CPU reductions, and the head products). Solutions agree to atol 1e-9
with equal Newton and CG trip counts: the trust-region decisions do not
flip on these fixtures, so both solvers take the same steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.ops.tron_multi as jtm
import mlease_tpu_torch.ops.tron_multi as ttm
from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core.dataset import to_hybrid

from test_admm import synth_rows
from test_tron_multi import make_multi

torch.set_num_threads(1)

LAYOUTS = ["ell", "hybrid", "hybrid_col"]


def to_torch(prob: jtm.MultiProblem) -> ttm.MultiProblem:
    # the JAX problem's boundary tables (tail_*_offsets) have no port field
    return ttm.MultiProblem(**{
        k: None if v is None else torch.as_tensor(np.array(v))
        for k, v in prob._asdict().items() if k in ttm.MultiProblem._fields})


def lanes_major(prob):
    """The (L, n) prior view both solvers use internally."""
    return prob._replace(prior_mean=prob.prior_mean.T,
                         prior_var_inv=prob.prior_var_inv.T)


def fixture(layout, seed=6, n_rows=120, L=3):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    n = vocab.size
    pvis = np.stack([np.full(n, lam) for lam in (0.5, 2.0, 8.0)[:L]])
    pms = np.stack([np.full(n, m) for m in (0.0, 0.05, -0.05)[:L]])
    _data, mp = make_multi(rows, vocab, pvis, pms,
                           hybrid=layout != "ell",
                           col_tails=layout == "hybrid_col")
    return rng, mp, to_torch(mp), n


def close(a, b, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lanes_major_passes_match_jax(layout):
    rng, jp, tp, n = fixture(layout)
    jp, tp = lanes_major(jp), lanes_major(tp)
    R = jp.y.shape[0]
    W = rng.normal(size=(3, n)) * 0.3
    D = rng.normal(size=(3, R))
    Dm = rng.random(size=(3, R))
    Wj, Wt = jnp.asarray(W), torch.as_tensor(W)
    Dj, Dt = jnp.asarray(D), torch.as_tensor(D)
    Dmj, Dmt = jnp.asarray(Dm), torch.as_tensor(Dm)

    close(ttm._xv_lm(tp, Wt), jtm._xv_lm(jp, Wj))
    close(ttm._xtv_lm(tp, Dt), jtm._xtv_lm(jp, Dj))
    for got, want in zip(ttm._xtv_and_sqdiag_lm(tp, Dt, Dmt),
                         jtm._xtv_and_sqdiag_lm(jp, Dj, Dmj)):
        close(got, want)
    close(ttm._hv_lm(tp, Dmt, Wt), jtm._hv_lm(jp, Dmj, Wj))
    close(ttm._grad_norm_at_zero_lm(tp, 3), jtm._grad_norm_at_zero_lm(jp, 3))
    for with_diag in (False, True):
        for got, want in zip(
                ttm._fun_grad_curvature_lm(tp, Wt, with_diag=with_diag),
                jtm._fun_grad_curvature_lm(jp, Wj, with_diag=with_diag)):
            close(got, want)


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tron_multi_matches_jax(layout, precondition):
    _rng, jp, tp, n = fixture(layout, seed=4, n_rows=200)
    want = jtm.tron_multi(jp, jnp.zeros((n, 3), jnp.float64), 1e-6,
                          precondition=precondition)
    got = ttm.tron_multi(tp, torch.zeros((n, 3), dtype=torch.float64), 1e-6,
                         precondition=precondition)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               rtol=0, atol=1e-9)
    close(got.f, want.f)
    assert got.newton_trips == int(want.newton_trips)
    assert got.cg_trips == int(want.cg_trips)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    assert bool(got.converged.all()) and bool(np.asarray(want.converged).all())


def _blocked(head_size, nblocks=3, n_rows=240):
    rng = np.random.default_rng(12)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    if head_size:
        data = to_hybrid(data, head_size)
    f64 = {k: np.asarray(getattr(data, k), np.float64)
           for k in ("values", "y", "weight", "offset", "head", "tail_vals",
                     "tail_c_vals") if getattr(data, k) is not None}
    return rng, data._replace(**f64)


def _head_arrays(data, lib):
    names = ("head", "head_ids", "tail_rows", "tail_cols", "tail_vals",
             "tail_c_rows", "tail_c_cols", "tail_c_vals")
    if data.head is None:
        return (None,) * 8
    return tuple(lib(getattr(data, k)) for k in names)


@pytest.mark.parametrize("head_size", [0, 4])
def test_stack_blocks_and_flat_solve_match_jax(head_size):
    """stack_blocks folds B blocks into the same flat problem, and the flat
    Jacobi solve (the ADMM x-update) matches."""
    rng, data = _blocked(head_size)
    B, n, L = data.nblocks, data.dim, 2
    pm = rng.normal(size=(L, B, n)) * 0.05
    rho = np.array([1.0, 10.0])
    args = [data.indices, data.values, data.y, data.weight, data.offset]
    jp = jtm.stack_blocks(*[jnp.asarray(a) for a in args],
                          _head_arrays(data, jnp.asarray), jnp.asarray(pm),
                          jnp.asarray(rho))
    tp = ttm.stack_blocks(*[torch.as_tensor(np.array(a)) for a in args],
                          _head_arrays(data, torch.as_tensor),
                          torch.as_tensor(pm), torch.as_tensor(rho))
    for k in ttm.MultiProblem._fields:
        got, v = getattr(tp, k), getattr(jp, k)
        assert (got is None) == (v is None), k
        if v is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(v), k)

    W0 = rng.normal(size=(B * n, L)) * 0.1
    want = jtm.tron_multi(jp, jnp.asarray(W0), 1e-5, precondition=True)
    got = ttm.tron_multi(tp, torch.as_tensor(W0), 1e-5, precondition=True)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               rtol=0, atol=1e-9)
    assert (got.newton_trips, got.cg_trips) == (int(want.newton_trips),
                                                int(want.cg_trips))


def test_stack_blocks_rejects_unsorted_tail():
    _rng, data = _blocked(4)
    tc_cols = data.tail_c_cols.copy()
    tc_cols[0, [0, 1]] = tc_cols[0, [1, 0]] + np.array([5, 0])
    L = 1
    args = [torch.as_tensor(np.array(a)) for a in (data.indices, data.values, data.y,
                                         data.weight, data.offset)]
    head = list(_head_arrays(data, torch.as_tensor))
    pm = torch.zeros((L, data.nblocks, data.dim), dtype=torch.float64)
    rho = torch.ones(L, dtype=torch.float64)
    ttm.stack_blocks(*args, tuple(head), pm, rho)     # sorted: accepted
    head[6] = torch.as_tensor(tc_cols)
    with pytest.raises(ValueError, match="non-decreasing"):
        ttm.stack_blocks(*args, tuple(head), pm, rho)
    rows = data.tail_rows.copy()
    rows[1, 0] = rows[1, -1] + 1
    head = list(_head_arrays(data, torch.as_tensor))
    head[2] = torch.as_tensor(rows)
    with pytest.raises(ValueError, match="tail_rows"):
        ttm.stack_blocks(*args, tuple(head), pm, rho)


def test_unported_and_unknown_preconditioners_raise():
    _rng, _jp, tp, n = fixture("hybrid_col", seed=9, n_rows=40, L=1)
    W0 = torch.zeros((n, 1), dtype=torch.float64)
    # head_block is ported: on the hybrid layout it solves (parity below);
    # without a dense head, or on a flat-blocks head, it raises as in JAX
    assert bool(ttm.tron_multi(tp, W0, 1e-6,
                               precondition="head_block").converged.all())
    _rng, _jp, ell, _n = fixture("ell", seed=9, n_rows=40, L=1)
    with pytest.raises(ValueError, match="head_block"):
        ttm.tron_multi(ell, W0, 1e-6, precondition="head_block")
    flat = tp._replace(head_x=tp.head_x[None])
    with pytest.raises(ValueError, match="head_block"):
        ttm.tron_multi(flat, W0, 1e-6, precondition="head_block")
    for bad in ("1", "yes", "Jacobi ", "head-block"):
        with pytest.raises(ValueError, match="precondition"):
            ttm.tron_multi(tp, W0, 1e-6, precondition=bad)


def _head_block_fixture():
    """The problem of tests/test_tron_multi.py's head-block test."""
    rng = np.random.default_rng(8)
    rows = synth_rows(rng, 200)
    vocab = build_vocab(rows)
    n = vocab.size
    pvis = np.stack([np.full(n, lam) for lam in (0.5, 4.0)])
    _data, jp = make_multi(rows, vocab, pvis, np.zeros((2, n)), hybrid=True,
                           col_tails=True)
    return jp, to_torch(jp), n


def test_head_block_precond_pieces_match_jax():
    """build_head_precond / _head_solve / _head_apply against the JAX
    functions (which are lanes-minor: transposed here). The JAX build runs
    in float64 on the CPU, so the float32 Cholesky bounds the factors to
    ~1e-6 and the products that use them likewise."""
    jp, tp, n = _head_block_fixture()
    rng = np.random.default_rng(1)
    R = jp.y.shape[0]
    Dm = rng.random(size=(2, R))
    Hd = rng.uniform(0.5, 3.0, size=(2, n))
    V = rng.normal(size=(2, n))
    jpc = jtm.build_head_precond(jp, jnp.asarray(Dm.T), jnp.asarray(Hd.T))
    tpc = ttm.build_head_precond(lanes_major(tp), torch.as_tensor(Dm),
                                 torch.as_tensor(Hd))
    close(tpc.chol, jpc.chol, rtol=1e-5, atol=1e-6)
    close(tpc.diag, np.asarray(jpc.diag).T)
    close(tpc.head_mask, np.asarray(jpc.head_mask).T)
    close(ttm._head_solve(tpc, torch.as_tensor(V)),
          np.asarray(jtm._head_solve(jpc, jnp.asarray(V.T))).T,
          rtol=1e-5, atol=1e-6)
    close(ttm._head_apply(tpc, torch.as_tensor(V)),
          np.asarray(jtm._head_apply(jpc, jnp.asarray(V.T))).T,
          rtol=1e-5, atol=1e-6)
    # M^{-1} M v = v to the factorisation's float32 accuracy
    back = ttm._head_solve(tpc, ttm._head_apply(tpc, torch.as_tensor(V)))
    close(back, V, rtol=1e-5, atol=1e-6)


def test_head_block_pcg_matches_jax_and_reaches_same_solution():
    """Parity with tests/test_tron_multi.py::
    test_head_block_pcg_reaches_same_solution: the same converged W as plain
    CG (rtol 1e-5, atol 1e-6: the solver's tolerance), never more CG trips
    than Jacobi, and W, trips and iterations equal to the JAX solver's (atol
    1e-7: both factor the head block in float32, with libraries that round
    differently)."""
    jp, tp, n = _head_block_fixture()
    W0 = torch.zeros((n, 2), dtype=torch.float64)
    plain = ttm.tron_multi(tp, W0, 1e-6)
    jac = ttm.tron_multi(tp, W0, 1e-6, precondition=True)
    blk = ttm.tron_multi(tp, W0, 1e-6, precondition="head_block")
    assert bool(blk.converged.all())
    np.testing.assert_allclose(blk.w.numpy(), plain.w.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert blk.cg_trips <= jac.cg_trips
    want = jtm.tron_multi(jp, jnp.zeros((n, 2), jnp.float64), 1e-6,
                          precondition="head_block")
    np.testing.assert_allclose(blk.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-7)
    assert (blk.newton_trips, blk.cg_trips) == (int(want.newton_trips),
                                                int(want.cg_trips))
    np.testing.assert_array_equal(blk.iterations.numpy(),
                                  np.asarray(want.iterations))


def test_head_block_requires_hybrid():
    """Parity with tests/test_tron_multi.py::test_head_block_requires_hybrid."""
    _rng, _jp, tp, n = fixture("ell", seed=9, n_rows=40, L=1)
    with pytest.raises(ValueError, match="head_block"):
        ttm.tron_multi(tp, torch.zeros((n, 1), dtype=torch.float64), 1e-6,
                       precondition="head_block")
