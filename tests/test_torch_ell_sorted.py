"""X'v over the ELL summed by K1 in one fixed order: the column-sorted copy
of a stacked problem's ELL slots (ops/tron_multi.py::with_column_copy,
made by stack_blocks and by the streaming trainer's shipped column order)
and the passes that sum over it (`_xtv_lm`, `_xtv_and_sqdiag_lm`,
`_hessian_diagonal_lm` and the public lanes-minor functions around them),
against the JAX package in float64 on the CPU, where K1 runs its plain
version; the head-less AdmmTrainer in its three multi-RHS solves against
the JAX trainer; and the sites that stay on the CPU.

The CPU-only sites: the `index_add_` / `scatter_add_` over the ELL of a
problem without its column-sorted copy, and over a row-sorted tail
without its column-sorted one, in the three lanes-major passes of
ops/tron_multi.py and in ops/objective.py's `xtv` and `hessian_diagonal`.
On the card each raises (`segment_sum.host_scatter_only`): their atomics
would sum in another order on every run. Every problem the port builds on
the card carries the copies (stack_blocks and streamed multi-RHS groups on
every device; blocked_problem and make_problem on the card, for the lanes
solve, the item buckets and `fit`).

Tolerances: the passes to rtol 1e-12 / atol 1e-14, the lanes-minor tests'
(tests/test_torch_lanes_minor.py); the trainers' z and u to 1e-8 with
equal trips (tests/test_torch_solve_loop.py); with and without the copy
on the CPU the same bits (K1's plain version adds a column's slots in the
ELL's row-major order, as `index_add_` over the ELL does); the loop
against the host-driven solve bit for bit.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.ops.tron_multi as jtm
import mlease_tpu_torch.ops.tron_multi as ttm
from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core.dataset import to_hybrid
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.admm import AdmmTrainer as JTrainer
from mlease_tpu_torch.ops import objective as tobj
from mlease_tpu_torch.ops import segment_sum
from mlease_tpu_torch.train.admm import (AdmmConfig, AdmmTrainer,
                                         blocked_problem)
from mlease_tpu_torch.train.streaming import (StreamingAdmmTrainer,
                                              _split_substacks)

from test_admm import synth_rows
from test_torch_tron_multi import to_torch

torch.set_num_threads(1)

L = 3


def ell_problems(seed=6, nblocks=3, n_rows=180):
    """(JAX stacked ELL problem, the port's with its column copy, the
    port's without it, numpy inputs) of `nblocks` blocks."""
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    B, n = data.nblocks, data.dim
    arrays = [np.asarray(data.indices)] + [
        np.asarray(getattr(data, k), np.float64)
        for k in ("values", "y", "weight", "offset")]
    pm = rng.normal(size=(L, B, n)) * 0.05
    rho = np.array([0.5, 2.0, 8.0])
    jp = jtm.stack_blocks(*[jnp.asarray(a) for a in arrays], (None,) * 8,
                          jnp.asarray(pm), jnp.asarray(rho))
    tp = ttm.stack_blocks(*[torch.as_tensor(a) for a in arrays], (None,) * 8,
                          torch.as_tensor(pm), torch.as_tensor(rho))
    R = B * data.padded_rows
    inputs = dict(W=rng.normal(size=(B * n, L)) * 0.3,
                  S=rng.normal(size=(B * n, L)),
                  C=rng.normal(size=(R, L)), Dm=rng.random(size=(R, L)))
    return jp, tp, to_torch(jp), inputs


CALLS = {
    "xtv": ("Dm",), "grad_and_curvature": ("W",),
    "xtv_and_sqdiag": ("C", "Dm"), "fun_grad_curvature": ("W",),
    "fun_grad_curvature_diag": ("W",), "grad_norm_at_zero": (),
    "hv": ("Dm", "S"), "hessian_diagonal": ("Dm",),
}


def _call(mod, name, prob, inputs, lib):
    args = [lib(inputs[a]) for a in CALLS[name]]
    if name == "fun_grad_curvature_diag":
        return mod.fun_grad_curvature(prob, *args, with_diag=True)
    if name == "grad_norm_at_zero":
        return mod.grad_norm_at_zero(prob, L)
    return getattr(mod, name)(prob, *args)


def close(got, want):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


@pytest.fixture
def k1_calls(monkeypatch):
    """The (seg, square_from) of every K1 call ops/tron_multi.py makes."""
    calls = []
    gather = ttm.segment_sum_gather

    def spy(vals, V, idx, seg, S, *, out=None, square_from=None):
        calls.append((seg, square_from))
        return gather(vals, V, idx, seg, S, out=out, square_from=square_from)
    monkeypatch.setattr(ttm, "segment_sum_gather", spy)
    return calls


@pytest.mark.parametrize("nblocks", [1, 3])
@pytest.mark.parametrize("name", list(CALLS))
def test_public_passes_with_the_copy_match_jax(k1_calls, name, nblocks):
    """Each public lanes-minor pass that sums X'v, on a stacked ELL problem
    carrying its column copy, equals the JAX function; its X'v is K1's
    (plain version) over the copy."""
    jp, tp, _tp, inputs = ell_problems(nblocks=nblocks)
    want = _call(jtm, name, jp, inputs, jnp.asarray)
    got = _call(ttm, name, tp, inputs, torch.as_tensor)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)
    assert any(seg is tp.csc_cols for seg, _sf in k1_calls)


PASSES = {
    "xtv": lambda p, C, Dm: (ttm._xtv_lm(p, Dm),),
    "xtv_and_sqdiag": lambda p, C, Dm: ttm._xtv_and_sqdiag_lm(p, C, Dm),
    "hessian_diagonal": lambda p, C, Dm: (ttm._hessian_diagonal_lm(p, Dm),),
}
# each pass's K1 call over the copy: square_from (None: no square)
SQUARE_FROM = {"xtv": None, "xtv_and_sqdiag": L, "hessian_diagonal": 0}


@pytest.mark.parametrize("name", list(PASSES))
def test_lanes_major_passes_with_the_copy_match_jax(k1_calls, name):
    """The three lanes-major passes over the copy (one K1 call each, the
    2L pass with square_from=L, the diagonal with 0) against the JAX
    lanes-minor functions, transposed."""
    jp, tp, _tp, inputs = ell_problems()
    lm = ttm.lanes_major(tp)
    C, Dm = (torch.as_tensor(inputs[k]).T.contiguous() for k in ("C", "Dm"))
    got = PASSES[name](lm, C, Dm)
    want = _call(jtm, name, jp, inputs, jnp.asarray)
    want = want if isinstance(want, tuple) else (want,)
    if name == "hessian_diagonal":
        # the lanes-major pass adds the prior precision in its own type
        got = (got[0],)
    for g, w in zip(got, want):
        close(g.T, w)
    assert [sf for seg, sf in k1_calls if seg is tp.csc_cols] == \
        [SQUARE_FROM[name]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_copy_keeps_the_ells_order(dtype):
    """The copy is the stable order of the stacked column ids (int32 ids,
    the values alike), and summing over it gives the bits of index_add_
    over the ELL, which it replaces (each column's slots in row-major
    order): the three passes, in float32 and float64."""
    jp, tp, tp_bare, inputs = ell_problems()
    idx = tp.indices.reshape(-1).numpy()
    order = np.argsort(idx, kind="stable")
    K = tp.indices.shape[1]
    np.testing.assert_array_equal(tp.csc_cols.numpy(), idx[order])
    np.testing.assert_array_equal(tp.csc_rows.numpy(), order // K)
    np.testing.assert_array_equal(tp.csc_vals.numpy(),
                                  tp.values.reshape(-1).numpy()[order])
    assert tp.csc_rows.dtype == tp.csc_cols.dtype == torch.int32
    assert tp_bare.csc_cols is None
    C, Dm = (torch.as_tensor(inputs[k]).T.contiguous().to(dtype)
             for k in ("C", "Dm"))

    def cast(p):
        return ttm.lanes_major(p._replace(**{
            f: getattr(p, f).to(dtype) for f in (
                "values", "y", "weight", "offset", "prior_mean",
                "prior_var_inv", "csc_vals") if getattr(p, f) is not None}))
    for name, fn in PASSES.items():
        for a, b in zip(fn(cast(tp), C, Dm), fn(cast(tp_bare), C, Dm)):
            assert torch.equal(a, b), name


def test_with_column_copy_and_the_naive_tails():
    """with_column_copy makes stack_blocks' copy of a problem built without
    it, and leaves a problem without ELL slots as it is;
    ell_as_sorted_tails takes its column-sorted tail from the copy (the ELL
    slots leave the problem, and so does the copy)."""
    _jp, tp, tp_bare, _i = ell_problems()
    made = ttm.with_column_copy(tp_bare)
    for f in ("csc_rows", "csc_cols", "csc_vals"):
        assert torch.equal(getattr(made, f), getattr(tp, f)), f
    empty = tp_bare._replace(indices=tp_bare.indices[:, :0],
                             values=tp_bare.values[:, :0])
    assert ttm.with_column_copy(empty) is empty
    tails = ttm.ell_as_sorted_tails(tp)
    assert tails.indices.shape[1] == 0 and tails.csc_cols is None
    assert torch.equal(tails.tail_c_cols, tp.csc_cols)
    assert torch.equal(tails.tail_c_rows, tp.csc_rows)
    bare_tails = ttm.ell_as_sorted_tails(tp_bare)
    for f in ttm.MultiProblem._fields:
        a, b = getattr(tails, f), getattr(bare_tails, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f


def test_host_scatter_only_refuses_a_card_tensor():
    """The guard of the CPU-only sites: nothing on a CPU tensor, ValueError
    on a tensor of the card (a stand-in with is_cuda set: there is no card
    here)."""
    segment_sum.host_scatter_only(torch.zeros(2), "X'v over the ELL")
    with pytest.raises(ValueError, match="column-sorted copy with K1"):
        segment_sum.host_scatter_only(types.SimpleNamespace(is_cuda=True),
                                      "X'v over the ELL")


def _hybrid(seed=6):
    """A one-block hybrid problem: JAX's, and the port's with only its
    row-sorted tail (the column-sorted one dropped)."""
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, 120)
    vocab = build_vocab(rows)
    data = to_hybrid(pack_blocks([rows], vocab), 4)
    n = data.dim
    head = [jnp.asarray(np.asarray(getattr(data, k), np.float64)
                        if k in ("head", "tail_vals", "tail_c_vals")
                        else getattr(data, k)) for k in (
        "head", "head_ids", "tail_rows", "tail_cols", "tail_vals",
        "tail_c_rows", "tail_c_cols", "tail_c_vals")]
    jp = jtm.stack_blocks(
        jnp.asarray(data.indices), *[jnp.asarray(np.asarray(
            getattr(data, k), np.float64)) for k in (
                "values", "y", "weight", "offset")], tuple(head),
        jnp.asarray(rng.normal(size=(L, 1, n)) * 0.05),
        jnp.asarray([0.5, 2.0, 8.0]))
    jp = jp._replace(tail_c_rows=None, tail_c_cols=None, tail_c_vals=None)
    R = jp.y.shape[0]
    return jp, to_torch(jp), dict(C=rng.normal(size=(R, L)),
                                  Dm=rng.random(size=(R, L)))


# the CPU-only sites of ops/tron_multi.py: (pass, layout)
TM_SITES = [(name, layout) for name in PASSES
            for layout in ("ELL without its copy", "a row-sorted tail")]


@pytest.mark.parametrize("name,layout", TM_SITES)
def test_cpu_only_sites_of_tron_multi(monkeypatch, name, layout):
    """Each pass on a problem without the sorted copy reaches the guard
    (on the card: ValueError) and, on the CPU, equals the JAX function."""
    if layout == "a row-sorted tail":
        jp, tp, inputs = _hybrid()
    else:
        jp, _tp, tp, inputs = ell_problems()
    seen = []
    monkeypatch.setattr(ttm, "host_scatter_only",
                        lambda t, what: seen.append(what))
    C, Dm = (torch.as_tensor(inputs[k]).T.contiguous() for k in ("C", "Dm"))
    got = PASSES[name](ttm.lanes_major(tp), C, Dm)
    want = _call(jtm, name, jp, inputs, jnp.asarray)
    for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
        close(g.T, w)
    assert seen == [("X'v over the ELL" if layout.startswith("ELL")
                     else "X'v over a row-sorted tail")]


def _lr_problem(with_head):
    """An LRProblem of 2 blocks as the lanes solve builds it on the CPU
    (no column copy), its priors set; with_head: the tail's column-sorted
    copy dropped."""
    rng = np.random.default_rng(3)
    rows = synth_rows(rng, 160)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[0::2], rows[1::2]], vocab)
    if with_head:
        data = to_hybrid(data, 4)
    t = torch.as_tensor
    head = (None,) * 8
    if with_head:
        head = (t(np.asarray(data.head, np.float64)), t(data.head_ids),
                t(data.tail_rows), t(data.tail_cols),
                t(np.asarray(data.tail_vals, np.float64)), None, None, None)
    B, n = data.nblocks, data.dim
    prob = blocked_problem(
        t(data.indices), *[t(np.asarray(getattr(data, k), np.float64))
                           for k in ("values", "y", "weight", "offset")],
        head, torch.float64, n)
    prob = prob._replace(prior_mean=t(rng.normal(size=(B, n)) * 0.05),
                         prior_var_inv=t(np.full((B, n), 2.0)))
    return prob, t(rng.normal(size=(B, n)) * 0.3)


@pytest.mark.parametrize("with_head", [False, True],
                         ids=["ELL without its copy", "a row-sorted tail"])
def test_cpu_only_sites_of_objective(monkeypatch, with_head):
    """ops/objective.py's xtv and hessian_diagonal on a problem without the
    sorted copy reach the guard (on the card: ValueError) and equal, on
    the CPU, the same problem with its copy (made here as the card makes
    it) within 1e-12."""
    prob, w = _lr_problem(with_head)
    seen = []
    monkeypatch.setattr(tobj, "host_scatter_only",
                        lambda t, what: seen.append(what))
    d = torch.as_tensor(np.random.default_rng(4).random(prob.y.shape))
    got = (tobj.xtv(prob, d), tobj.hessian_diagonal(prob, w))
    if with_head:
        cols = prob.tail_cols
        order = torch.sort(cols, dim=1, stable=True).indices
        sorted_prob = prob._replace(
            tail_c_cols=cols.gather(1, order),
            tail_c_rows=prob.tail_rows.gather(1, order),
            tail_c_vals=prob.tail_vals.gather(1, order))
        site = "a row-sorted tail"
    else:
        cols, rows, vals = tobj.column_sorted(prob.indices, prob.values)
        sorted_prob = prob._replace(csc_cols=cols, csc_rows=rows,
                                    csc_vals=vals)
        site = "the ELL"
    want = (tobj.xtv(sorted_prob, d), tobj.hessian_diagonal(sorted_prob, w))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-12,
                                   atol=1e-14)
    assert seen == [f"X'v over {site}",
                    f"The Hessian diagonal over {site}"]


def _data(nblocks=4, seed=11):
    rows = synth_rows(np.random.default_rng(seed), 80 * nblocks)
    vocab = build_vocab(rows)
    return pack_blocks([rows[i::nblocks] for i in range(nblocks)],
                       vocab), vocab


# the head-less multi-RHS solves: (config, solve mode, sub-stacks)
SOLVES = {"flat": (dict(), "flat", 1),
          "per_block": (dict(flat_blocks=False), "per_block", 1),
          "4 substacks": (dict(), "per_block", 4)}


@pytest.mark.parametrize("name", list(SOLVES))
def test_headless_trainer_matches_jax(monkeypatch, k1_calls, name):
    """AdmmTrainer without a head (head.size = 0, the reference job's
    layout) in its three multi-RHS solves (4 sub-stacks past the lowered
    int32 bound) against the JAX trainer (its per-block solve for the
    sub-stacks) in float64: z and u to 1e-8, equal trips; X'v is K1's over
    the copy, no site reaches the guard, and run()'s loop gives the
    host-driven solve's bits."""
    kw, mode, parts = SOLVES[name]
    data, vocab = _data()
    if parts > 1:
        monkeypatch.setattr(ttm, "STACK_ID_BOUND",
                            max(data.dim, data.padded_rows) + 1)
    base = dict(lambdas=[1.0, 10.0], num_iters=4, **kw)
    seen = []
    monkeypatch.setattr(ttm, "host_scatter_only",
                        lambda t, what: seen.append(what))
    tr = AdmmTrainer(data, vocab, AdmmConfig(dtype=torch.float64, **base),
                     device="cpu")
    assert tr.mode == mode
    probs = ttm.substacks_of(tr.prob, data.nblocks)
    assert len(probs) == parts
    assert all(p.csc_cols is not None for p, _r in probs)
    got = tr.run()
    assert seen == []
    assert any(seg is p.csc_cols for p, _r in probs for seg, _s in k1_calls)

    solve = tr.step.solve

    def host(z, u, rho_eff, eps):
        x, trips = solve(tr.prob, tr.present, z, u, rho_eff, eps)
        return x, torch.as_tensor(trips)
    tr._x_update = host
    hres = tr.run()
    np.testing.assert_array_equal(got.z, hres.z)
    np.testing.assert_array_equal(got.u, hres.u)
    assert got.solver_stats == hres.solver_stats

    jkw = dict(base, flat_blocks=False) if parts > 1 else base
    want = JTrainer(data, vocab, JConfig(dtype=jnp.float64, **jkw)).run()
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]


@pytest.mark.parametrize("split", [(4,), (1, 3)])
def test_streamed_group_ships_stack_blocks_copy(monkeypatch, split):
    """A streamed head-less group's problem, as shipped (its column order
    made once on the host, the copy gathered on the device), carries the
    copy stack_blocks makes of the same blocks, bit for bit: one group of
    4 blocks in 2 sub-stacks (the bound lowered), and 1 + 3 blocks."""
    data, vocab = _data()
    if split == (4,):
        monkeypatch.setattr(ttm, "STACK_ID_BOUND",
                            2 * max(data.dim, data.padded_rows) + 1)
    groups, lo = [], 0
    for k in split:
        groups.append(data._replace(**{
            f: getattr(data, f)[lo:lo + k] for f in (
                "indices", "values", "y", "weight", "offset", "present",
                "nrows")}, nblocks=k))
        lo += k
    cfg = AdmmConfig(lambdas=[1.0, 10.0], dtype=torch.float64,
                     flat_blocks=False)
    st = StreamingAdmmTrainer(groups, vocab, cfg, device="cpu",
                              resident_head=False)
    for gi, g in enumerate(groups):
        prob = st._put_group(gi)[0]
        if len(st.ranges[gi]) > 1:
            prob = _split_substacks(prob, st.ranges[gi])
        t = torch.as_tensor
        want = ttm.stack_substacks(
            t(g.indices), *[t(np.asarray(getattr(g, k), np.float64)) for k in (
                "values", "y", "weight", "offset")], (None,) * 8,
            torch.zeros((2, g.nblocks, g.dim), dtype=torch.float64),
            torch.ones(2, dtype=torch.float64))
        got_parts = ttm.substacks_of(prob, g.nblocks)
        want_parts = ttm.substacks_of(want, g.nblocks)
        assert [r for _p, r in got_parts] == [r for _p, r in want_parts]
        for (a, _r), (b, _s) in zip(got_parts, want_parts):
            for f in ("indices", "csc_rows", "csc_cols", "csc_vals"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (gi, f)
