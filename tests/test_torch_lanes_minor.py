"""The port's public lanes-minor pass functions (mlease_tpu_torch.ops.
tron_multi: xv, xtv, scores, fun, grad_and_curvature, xtv_and_sqdiag,
fun_grad_curvature, grad_norm_at_zero, hv, hessian_diagonal) against the
JAX package's, float64 on the CPU, on the fixtures of
tests/test_tron_multi.py::make_multi and a 3-block stack_blocks problem.

Tolerances: every output to rtol 1e-12 / atol 1e-14, the lanes-major
passes' tolerance (tests/test_torch_tron_multi.py: the two packages add the
same terms in orders that differ only inside one sum). The identities of
tests/test_tron_multi.py are held at the tolerances that file states. The
bfloat16 case follows tests/test_torch_bf16.py's rule.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.ops.tron_multi as jtm
import mlease_tpu_torch.ops.tron_multi as ttm
from mlease_tpu.core import build_vocab, pack_blocks, pack_rows
from mlease_tpu.core.dataset import to_hybrid
from mlease_tpu_torch.ops import objective as tobj

from test_admm import synth_rows
from test_torch_bf16 import assert_rule
from test_torch_tron_multi import to_torch
from test_tron_multi import make_multi

torch.set_num_threads(1)

# ELL; a 2-D head with the tail unsorted or with its column-sorted copy;
# three blocks folded flat (3-D head), with and without that copy
LAYOUTS = ["ell", "hybrid", "hybrid_col", "flat", "flat_col"]
L = 3


def _flat(rng, with_col):
    rows = synth_rows(rng, 180)
    vocab = build_vocab(rows)
    data = to_hybrid(pack_blocks([rows[i::3] for i in range(3)], vocab), 4)
    B, n = data.nblocks, data.dim
    f64 = {k: np.asarray(getattr(data, k), np.float64)
           for k in ("values", "y", "weight", "offset", "head", "tail_vals",
                     "tail_c_vals")}
    data = data._replace(**f64)
    head = tuple(jnp.asarray(getattr(data, k)) for k in (
        "head", "head_ids", "tail_rows", "tail_cols", "tail_vals",
        "tail_c_rows", "tail_c_cols", "tail_c_vals"))
    pm = rng.normal(size=(L, B, n)) * 0.05
    jp = jtm.stack_blocks(*[jnp.asarray(getattr(data, k)) for k in (
        "indices", "values", "y", "weight", "offset")], head,
        jnp.asarray(pm), jnp.asarray([0.5, 2.0, 8.0]))
    if not with_col:
        jp = jp._replace(tail_c_rows=None, tail_c_cols=None,
                         tail_c_vals=None)
    return jp


@functools.lru_cache(maxsize=None)
def fixture(layout, seed=6):
    """(JAX problem, port problem, numpy inputs) of one layout."""
    rng = np.random.default_rng(seed)
    if layout.startswith("flat"):
        jp = _flat(rng, layout == "flat_col")
    else:
        rows = synth_rows(rng, 120)
        for r in rows:
            r["offset"] = float(rng.normal() * 0.5)
        vocab = build_vocab(rows)
        n = vocab.size
        pvis = np.stack([np.full(n, lam) for lam in (0.5, 2.0, 8.0)])
        pms = rng.normal(size=(L, n)) * 0.05
        _data, jp = make_multi(rows, vocab, pvis, pms,
                               hybrid=layout != "ell",
                               col_tails=layout == "hybrid_col")
    n, R = jp.prior_mean.shape[0], jp.y.shape[0]
    inputs = dict(W=rng.normal(size=(n, L)) * 0.3,
                  S=rng.normal(size=(n, L)),
                  C=rng.normal(size=(R, L)),
                  Dm=rng.random(size=(R, L)))
    return jp, to_torch(jp), inputs


def close(got, want, rtol=1e-12, atol=1e-14):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# name -> (arguments after prob, from the fixture's inputs)
CALLS = {
    "xv": ("W",), "xtv": ("Dm",), "scores": ("W",), "fun": ("W",),
    "grad_and_curvature": ("W",), "xtv_and_sqdiag": ("C", "Dm"),
    "fun_grad_curvature": ("W",), "fun_grad_curvature_diag": ("W",),
    "grad_norm_at_zero": (), "hv": ("Dm", "S"), "hessian_diagonal": ("Dm",),
}


def _call(mod, name, prob, inputs, lib):
    args = [lib(inputs[a]) for a in CALLS[name]]
    if name == "fun_grad_curvature_diag":
        return mod.fun_grad_curvature(prob, *args, with_diag=True)
    if name == "grad_norm_at_zero":
        return mod.grad_norm_at_zero(prob, L)
    return getattr(mod, name)(prob, *args)


@pytest.mark.parametrize("name", list(CALLS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_public_pass_matches_jax(layout, name):
    """Each public pass function equals the JAX function of the same name,
    in every layout, with (n, L) / (R, L) in and out."""
    jp, tp, inputs = fixture(layout)
    want = _call(jtm, name, jp, inputs, jnp.asarray)
    got = _call(ttm, name, tp, inputs, torch.as_tensor)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_public_passes_are_the_solver_passes(layout):
    """Each public function is the lanes-major pass the solver runs, on the
    transposed operands: the same bits."""
    _jp, tp, inputs = fixture(layout)
    lm = ttm.lanes_major(tp)
    W, S, C, Dm = (torch.as_tensor(inputs[k]) for k in ("W", "S", "C", "Dm"))
    Wl, Sl, Cl, Dml = (t.T.contiguous() for t in (W, S, C, Dm))

    def same(got, want):
        torch.testing.assert_close(got, want.T, rtol=0, atol=0)
    same(ttm.xv(tp, W), ttm._xv_lm(lm, Wl))
    same(ttm.xtv(tp, Dm), ttm._xtv_lm(lm, Dml))
    same(ttm.hv(tp, Dm, S), ttm._hv_lm(lm, Dml, Sl))
    for got, want in zip(ttm.xtv_and_sqdiag(tp, C, Dm),
                         ttm._xtv_and_sqdiag_lm(lm, Cl, Dml)):
        same(got, want)
    F, *rest = ttm.fun_grad_curvature(tp, W, with_diag=True)
    F_lm, *rest_lm = ttm._fun_grad_curvature_lm(lm, Wl, with_diag=True)
    torch.testing.assert_close(F, F_lm, rtol=0, atol=0)
    for got, want in zip(rest, rest_lm):
        same(got, want)
    torch.testing.assert_close(ttm.grad_norm_at_zero(tp, L),
                               ttm._grad_norm_at_zero_lm(lm, L),
                               rtol=0, atol=0)
    # the diagonal's data part is the second half of xtv_and_sqdiag
    pvi = torch.broadcast_to(tp.prior_var_inv, W.shape)
    torch.testing.assert_close(ttm.hessian_diagonal(tp, Dm) - pvi,
                               ttm.xtv_and_sqdiag(tp, C, Dm)[1],
                               rtol=1e-12, atol=1e-14)


def test_multi_objective_consistency():
    """Parity with tests/test_tron_multi.py::
    test_multi_objective_consistency: each lane of fun and
    grad_and_curvature is the port's single-lambda objective."""
    rng = np.random.default_rng(1)
    rows = synth_rows(rng, 80)
    vocab = build_vocab(rows)
    n = vocab.size
    pvis = np.stack([np.full(n, 1.0), np.full(n, 4.0)])
    pms = np.zeros((2, n))
    _data, jp = make_multi(rows, vocab, pvis, pms)
    tp = to_torch(jp)
    W = torch.as_tensor(rng.normal(size=(n, 2)) * 0.2)
    blk = pack_rows(rows, vocab)
    F = ttm.fun(tp, W)
    g_m, d_m = ttm.grad_and_curvature(tp, W)
    for i in range(2):
        prob = tobj.make_problem(blk, pms[i], pvis[i], dtype=torch.float64,
                                 device="cpu")
        w = W[:, i][None]
        assert float(F[i]) == pytest.approx(
            float(tobj.fun(prob, w).reshape(())), rel=1e-12)
        g_s, d_s = tobj.grad_and_curvature(prob, w)
        np.testing.assert_allclose(g_m[:, i].numpy(), g_s.reshape(-1).numpy(),
                                   rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(d_m[:, i].numpy(), d_s.reshape(-1).numpy(),
                                   rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_grad_diag_exact(layout):
    """Parity with tests/test_tron_multi.py::test_fused_grad_diag_exact:
    fun_grad_curvature(with_diag=True) equals (fun, grad_and_curvature,
    hessian_diagonal) in every layout."""
    _jp, tp, inputs = fixture(layout)
    W = torch.as_tensor(inputs["W"])
    F, G, Dm = ttm.fun_grad_curvature(tp, W)
    F2, G2, Dm2, Hd = ttm.fun_grad_curvature(tp, W, with_diag=True)
    np.testing.assert_allclose(F2.numpy(), F.numpy(), rtol=1e-14)
    np.testing.assert_allclose(F.numpy(), ttm.fun(tp, W).numpy(), rtol=1e-14)
    np.testing.assert_allclose(G2.numpy(), G.numpy(), rtol=1e-12, atol=1e-14)
    G3, Dm3 = ttm.grad_and_curvature(tp, W)
    np.testing.assert_array_equal(G3.numpy(), G.numpy())
    np.testing.assert_array_equal(Dm2.numpy(), Dm.numpy())
    np.testing.assert_array_equal(Dm3.numpy(), Dm.numpy())
    np.testing.assert_allclose(Hd.numpy(),
                               ttm.hessian_diagonal(tp, Dm).numpy(),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("layout", ["ell", "hybrid_col", "flat_col"])
def test_grad_norm_at_zero_exact(layout):
    """Parity with tests/test_tron_multi.py::test_grad_norm_at_zero_exact:
    grad_norm_at_zero is ||grad_and_curvature(prob, 0)[0]|| per lane."""
    _jp, tp, inputs = fixture(layout)
    G0, _ = ttm.grad_and_curvature(tp, torch.zeros_like(
        torch.as_tensor(inputs["W"])))
    np.testing.assert_allclose(ttm.grad_norm_at_zero(tp, L).numpy(),
                               torch.sqrt((G0 * G0).sum(0)).numpy(),
                               rtol=1e-14)


# the largest of the port's max|z_t - z_j64| / max|z_j64| over the outputs
# of the bfloat16 case when it was written (xv's), rounded up: tests/
# test_torch_bf16.py's PORT_REL (JAX's own bfloat16 error here is 0.4-0.9%)
BF16_PORT_REL = 4.9e-3
BF16_OUTPUTS = ["xv", "xtv", "scores", "fun", "grad_and_curvature",
                "xtv_and_sqdiag", "fun_grad_curvature_diag",
                "grad_norm_at_zero", "hv", "hessian_diagonal"]


def _bf16(jp, tp):
    """Both problems with every float field in bfloat16 (ids as they are)."""
    return (jp._replace(**{k: jnp.asarray(v, jnp.bfloat16)
                           for k, v in jp._asdict().items()
                           if v is not None
                           and jnp.issubdtype(v.dtype, jnp.floating)}),
            tp._replace(**{k: v.to(torch.bfloat16)
                           for k, v in tp._asdict().items()
                           if v is not None and v.is_floating_point()}))


def test_bf16_hybrid_col_within_rule():
    """The bfloat16 case (hybrid, column-sorted tail) within tests/
    test_torch_bf16.py's rule against the JAX package in float64 and in
    bfloat16; the vectors come back bfloat16, F and the norm as the
    solver keeps them."""
    jp64, tp64, inputs = fixture("hybrid_col")
    jbf, tbf = _bf16(jp64, tp64)
    for name in BF16_OUTPUTS:
        want64 = _call(jtm, name, jp64, inputs, jnp.asarray)
        wantbf = _call(jtm, name, jbf, inputs,
                       lambda a: jnp.asarray(a, jnp.bfloat16))
        got = _call(ttm, name, tbf, inputs,
                    lambda a: torch.as_tensor(a).to(torch.bfloat16))
        if not isinstance(want64, tuple):
            want64, wantbf, got = (want64,), (wantbf,), (got,)
        for k, (g, wb, w64) in enumerate(zip(got, wantbf, want64)):
            is_f = name.startswith("fun") and k == 0
            assert g.dtype == (torch.float32 if is_f else torch.bfloat16), \
                (name, k, g.dtype)
            assert_rule(g.float().numpy(), np.asarray(wb, np.float32),
                        np.asarray(w64), BF16_PORT_REL)
