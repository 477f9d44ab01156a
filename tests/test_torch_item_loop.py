"""The item trainer's bucket solves as device loops (train/item.py::
_solve_bucket: the Cholesky route on ops/newton.py::NewtonSolver's
branches, the TRON route on train/admm.py::_SolveLoop's lanes solve)
against the host-driven newton_cholesky and tron they replaced, and
against the JAX package, on the CPU, where the loop takes the branches the
card captures eagerly. Data from tests/test_admm.py::synth_rows.

Tolerances: the loop against the host-driven solve on the same buckets bit
for bit with equal trips (the same ops on the same values in the same
order: models, posterior variances and covariances as the trainer returns
them); against the JAX trainer in float64 tests/test_torch_item.py's (w
rtol 1e-6, variances 1e-5; both packages factor H in float32, which LAPACK
and XLA round differently); in bfloat16 tests/test_torch_bf16.py's rule.
NewtonSolver against the JAX newton_cholesky: where the lanes converge, w
to 1e-9 absolute with equal per-lane iterations and convergence flags, the
distance the float32 factorisations leave after the last, small, Newton
step (at most 1.3e-10 measured on these lanes, max|w| 0.3-2.0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.train.item as jitem
import mlease_tpu_torch.train.item as titem
from mlease_tpu.ops.newton import newton_cholesky as jnewton
from mlease_tpu_torch.ops.newton import NewtonSolver, newton_cholesky

from test_admm import synth_rows
from test_torch_item import _flat, assert_results_close
from test_torch_tron import batch
from torch_host_solves import host_bucket
from torch_mesh_worker import launch

torch.set_num_threads(1)


def keyed_rows(seed=0):
    """Items in three (R, K, F) buckets, one with an empty row."""
    rng = np.random.default_rng(seed)
    keyed = {"a": synth_rows(rng, 60, n_feat=5),
             "b": synth_rows(rng, 200, n_feat=9),
             "c": synth_rows(rng, 17, n_feat=3),
             "d": synth_rows(rng, 60, n_feat=5)}
    keyed["c"][2]["features"] = []
    return keyed


def both(monkeypatch, keyed, cfg):
    """The trainer on its loops, then with its seam on the host-driven
    solvers."""
    loop = titem.train_item_models(keyed, cfg, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(titem, "_solve_bucket", host_bucket)
        host = titem.train_item_models(keyed, cfg, device="cpu")
    return loop, host


def assert_same_bits(a, b):
    for field in ("models", "posterior_var"):
        ga, gb = getattr(a, field), getattr(b, field)
        assert sorted(ga) == sorted(gb)
        np.testing.assert_array_equal(_flat(ga), _flat(gb))
    assert (a.covariances is None) == (b.covariances is None)
    if a.covariances is not None:
        assert a.covariances == b.covariances
    untimed = [{k: v for k, v in s.items() if not k.endswith("_s")}
               for s in a.solver_stats]
    assert untimed == [{k: v for k, v in s.items() if not k.endswith("_s")}
                       for s in b.solver_stats]


CASES = {          # solver, compute_var, full_cov, max_newton_iter
    "cholesky-diag": ("cholesky", True, False, 1000),
    "cholesky-full_cov": ("cholesky", True, True, 1000),
    "cholesky-no_var": ("cholesky", False, False, 1000),
    "cholesky-capped": ("cholesky", True, False, 2),
    "tron-diag": ("tron", True, False, 1000),
    "tron-full_cov": ("tron", True, True, 1000),
    "tron-capped": ("tron", True, True, 2),
}


@pytest.mark.parametrize("solver,var,full,cap", CASES.values(),
                         ids=CASES.keys())
def test_loop_equals_host_and_jax(monkeypatch, solver, var, full, cap):
    """Every bucket on its loop against the host-driven solve, bit for bit
    with equal trips, and against the JAX trainer
    in float64; a lambda.map with a feature absent from the data, and
    max_newton_iter reached where capped."""
    keyed = keyed_rows()
    kw = dict(intercept_lambdas=[1.0, 5.0], default_lambdas=[2.0],
              compute_var=var, full_cov=full, solver=solver,
              lambda_map={"not_in_data": 4.0, "f1": 9.0},
              liblinear_epsilon=1e-5, max_newton_iter=cap)
    cfg = titem.ItemConfig(dtype=torch.float64, **kw)
    loop, host = both(monkeypatch, keyed, cfg)
    assert_same_bits(loop, host)
    assert [s["shape"] for s in loop.solver_stats] == [
        (32, 8, 8), (64, 8, 8), (256, 16, 16)]
    if cap == 2:
        assert all(s["newton_trips"] == 2 for s in loop.solver_stats)
    if var:
        assert loop.posterior_var["1.0:2.0#a"].coefficients[
            "not_in_data"] == pytest.approx(0.25)
    want = jitem.train_item_models(keyed, jitem.ItemConfig(
        dtype=jnp.float64, **kw))
    assert_results_close(loop, want)
    if full:
        for key, cov in want.covariances.items():
            for pair, v in cov.items():
                np.testing.assert_allclose(loop.covariances[key][pair], v,
                                           rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_columnar_loop_equals_host(monkeypatch, solver):
    """train_item_models_columnar, the CLI's entry, on its loops against
    the host-driven solves: bit for bit, equal trips."""
    from test_torch_item import _columnar_case
    _keyed, kw, _jdec, tdec = _columnar_case()
    cfg = titem.ItemConfig(dtype=torch.float64, solver=solver, **kw)
    loop = titem.train_item_models_columnar(tdec, cfg, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(titem, "_solve_bucket", host_bucket)
        host = titem.train_item_models_columnar(tdec, cfg, device="cpu")
    assert_same_bits(loop, host)


@pytest.mark.parametrize("full", [False, True], ids=["diag", "full_cov"])
@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_column_sorted_items_match_the_ell_route(monkeypatch, solver, full):
    """The item problem as the card builds it, with its column-sorted copy
    (X'v, the gradient, Hv and the Hessian diagonal's squared values summed
    over it, as K1 sums them there; here the CPU's scatter over the same
    stream), against the ELL problem the CPU builds: models and variances
    to 1e-9 relative in float64 (the two sum in different orders), equal
    trips."""
    from mlease_tpu_torch.ops.objective import column_sorted
    from mlease_tpu_torch.train import admm
    keyed = keyed_rows(5)
    cfg = titem.ItemConfig(intercept_lambdas=[1.0, 5.0],
                           default_lambdas=[2.0], compute_var=True,
                           full_cov=full, solver=solver,
                           liblinear_epsilon=1e-6, dtype=torch.float64)
    ell = titem.train_item_models(keyed, cfg, device="cpu")
    seen = []

    def with_csc(indices, values, *a, **kw):
        prob = admm.blocked_problem(indices, values, *a,
                                    csc=column_sorted(indices, values), **kw)
        seen.append(prob.csc_cols is not None)
        return prob
    monkeypatch.setattr(titem, "blocked_problem", with_csc)
    csc = titem.train_item_models(keyed, cfg, device="cpu")
    assert seen == [True] * len(ell.solver_stats)
    assert [s["newton_trips"] for s in csc.solver_stats] == [
        s["newton_trips"] for s in ell.solver_stats]
    for field in ("models", "posterior_var"):
        np.testing.assert_allclose(_flat(getattr(csc, field)),
                                   _flat(getattr(ell, field)),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_bf16_loop_equals_host_and_jax_rule(monkeypatch, solver):
    """bfloat16 items on their loops: the host-driven solve's bits, and
    tests/test_torch_bf16.py's rule against the JAX package's bfloat16 and
    float64 items (within 2 * max(e_j, 2^-8 * max|w_j64|), e_j JAX's own
    bfloat16 error)."""
    rng = np.random.default_rng(0)
    keyed = {"itemA": synth_rows(rng, 60, n_feat=5),
             "itemB": synth_rows(rng, 200, n_feat=9)}
    kw = dict(intercept_lambdas=[1.0, 5.0], default_lambdas=[2.0],
              compute_var=True, liblinear_epsilon=1e-5, solver=solver)
    loop, host = both(monkeypatch, keyed,
                      titem.ItemConfig(dtype=torch.bfloat16, **kw))
    assert_same_bits(loop, host)
    want64, wantbf = (jitem.train_item_models(
        keyed, jitem.ItemConfig(dtype=dt, **kw))
        for dt in (jnp.float64, jnp.bfloat16))
    for field in ("models", "posterior_var"):
        gf, bf, wf = (_flat(getattr(r, field))
                      for r in (loop, wantbf, want64))
        bound = 2 * max(np.abs(bf - wf).max(), 2.0 ** -8 * np.abs(wf).max())
        assert np.isfinite(gf).all()
        assert np.abs(gf - bf).max() <= bound, field
        assert np.abs(gf - wf).max() <= bound, field


def test_two_loop_runs_give_the_same_bits():
    """A second call makes its loops anew and gives the same bits."""
    keyed = keyed_rows(3)
    cfg = titem.ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0],
                           compute_var=True, full_cov=True,
                           dtype=torch.float64)
    assert_same_bits(titem.train_item_models(keyed, cfg, device="cpu"),
                     titem.train_item_models(keyed, cfg, device="cpu"))


def _newton_loop_run(tprob, w0, eps, max_iter=50):
    """NewtonSolver's branches through the item trainer's device loop
    (eager on the CPU)."""
    lp = titem._NewtonLoop(NewtonSolver(tprob, max_iter), w0, eps)
    lp.own_loop().prepare()
    lp.set_inputs(w0, eps)
    lp.loop.run()
    counts = lp.loop.counts()["branch_executions"]
    lp.close()
    return lp.solver.result(lp.ns), counts


@pytest.mark.parametrize("eps,max_iter,tol", [
    (1e-7, 50, dict(rtol=0, atol=1e-9)),
    (1e-12, 2, dict(rtol=1e-5, atol=1e-7))], ids=["converged", "capped"])
def test_newton_solver_matches_jax(eps, max_iter, tol):
    """NewtonSolver on its loop: newton_cholesky's bits and trips, one
    Newton step and finish a trip, and the JAX newton_cholesky lane by
    lane in float64, iterations and converged equal: w to 1e-9 where the
    lanes converge; cut after 2 steps, the last step is large and the two
    float32 factorisations leave their 1e-7 relative mark on it, held to
    tests/test_torch_tron.py's rtol 1e-5."""
    jprobs, tprob = batch()
    n = tprob.dim
    w0 = torch.zeros((len(jprobs), n), dtype=torch.float64)
    got, counts = _newton_loop_run(tprob, w0, eps, max_iter)
    host = newton_cholesky(tprob, w0, eps, max_iter=max_iter)
    assert torch.equal(got.w, host.w) and got.trips == host.trips
    assert counts["newton_step"] == counts["newton_finish"] == got.trips
    assert counts["backtrack"] >= got.trips
    iters = set()
    for i, p in enumerate(jprobs):
        want = jnewton(p, jnp.zeros(n, jnp.float64), eps, max_iter=max_iter)
        np.testing.assert_allclose(got.w[i].numpy(), np.asarray(want.w),
                                   **tol)
        assert int(got.iterations[i]) == int(want.iterations)
        assert bool(got.converged[i]) == bool(want.converged)
        iters.add(int(want.iterations))
    assert got.trips == max(iters)


@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_item_loops_on_two_ranks_match_jax_mesh(tmp_path, solver):
    """Items on their loops sharded over 2 gloo ranks (5 items padded to 6)
    against the JAX package on a 2-device mesh and against the port's own
    run without a mesh: every rank the same result; models and variances
    to 1e-10 relative with TRON (both packages take the same steps), to
    tests/test_torch_item.py's tolerances with Cholesky; the trips (the
    slowest rank's) the unsharded run's."""
    import jax

    from mlease_tpu.parallel import make_mesh
    rng = np.random.default_rng(17)
    keyed = {f"k{i}": synth_rows(rng, 40, n_feat=5) for i in range(5)}
    kw = dict(intercept_lambdas=[1.0], default_lambdas=[1.0, 4.0],
              compute_var=True, full_cov=True, solver=solver)
    want = jitem.train_item_models(keyed, jitem.ItemConfig(
        dtype=jnp.float64, **kw), mesh=make_mesh(jax.devices("cpu"), n=2))
    per_rank = launch([("item", "item", dict(
        keyed=keyed, mesh=2, config=dict(kw, dtype="float64")))], 2,
        tmp_path)["item"]
    assert per_rank[1] == per_rank[0]
    got = per_rank[0]
    plain = titem.train_item_models(keyed, titem.ItemConfig(
        dtype=torch.float64, **kw), device="cpu")
    assert [s["newton_trips"] for s in got["stats"]] == [
        s["newton_trips"] for s in plain.solver_stats]
    rtol = 1e-10 if solver == "tron" else 1e-6
    for field, want_m in (("models", want.models),
                          ("pvar", want.posterior_var)):
        assert set(got[field]) == set(want_m)
        for key, m in want_m.items():
            icpt, coefs = got[field][key]
            np.testing.assert_allclose(
                [icpt] + [coefs[f] for f in sorted(coefs)],
                [m.intercept] + [m.coefficients[f] for f in sorted(coefs)],
                rtol=rtol if field == "models" or solver == "tron" else 1e-5,
                atol=1e-12 if solver == "tron" else 1e-8)
