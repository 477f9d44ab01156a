"""The port's per-item trainer (mlease_tpu_torch.train.item) against
mlease_tpu.train.item on the same rows, float64 on the CPU; mirrors
tests/test_item.py.

Tolerances: coefficients rtol 1e-6 (atol 1e-8), posterior variances rtol
1e-5. With solver="tron" both packages take the same steps; with
solver="cholesky" each Newton step goes through a float32 factorisation,
which LAPACK and XLA round differently, and the converged iterates differ
by that rounding times the last, small, step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.train.item as jitem
import mlease_tpu_torch.train.item as titem
from mlease_tpu.io import avro as javro
from mlease_tpu.io.fast_decode import DecodedRows as JDecodedRows
from mlease_tpu_torch.convert import item_models_from_jax
from mlease_tpu_torch.io import avro as tavro
from mlease_tpu_torch.io.records import INTERCEPT_NAME

from test_admm import synth_rows
from test_item import _decoded_from_keyed
from torch_mesh_worker import launch

torch.set_num_threads(1)

SOLVERS = ["cholesky", "tron"]


def configs(**kw):
    """The same ItemConfig for both packages (float64)."""
    return (jitem.ItemConfig(dtype=jnp.float64, **kw),
            titem.ItemConfig(dtype=torch.float64, **kw))


def assert_models_close(got, want, rtol=1e-6, atol=1e-8):
    assert set(got) == set(want)
    for key, m in want.items():
        g = got[key]
        assert set(g.coefficients) == set(m.coefficients), key
        np.testing.assert_allclose(g.intercept, m.intercept, rtol=rtol,
                                   atol=atol, err_msg=key)
        for name, v in m.coefficients.items():
            np.testing.assert_allclose(g.coefficients[name], v, rtol=rtol,
                                       atol=atol, err_msg=f"{key} {name}")


def assert_results_close(got, want):
    assert_models_close(got.models, want.models)
    assert_models_close(got.posterior_var, want.posterior_var, rtol=1e-5)


def _flat(models):
    return np.array([v for k in sorted(models) for v in
                     [models[k].intercept]
                     + [models[k].coefficients[n]
                        for n in sorted(models[k].coefficients)]])


@pytest.mark.parametrize("solver", SOLVERS)
def test_item_bf16_matches_jax(solver):
    """Items in bfloat16, both solvers, against the JAX package's bfloat16
    and float64 items under tests/test_torch_bf16.py's rule: models and
    posterior variances within 2 * max(e_j, 2^-8 * max|w_j64|) of both, e_j
    JAX's own bfloat16 error, and within twice the port's own measured
    distance from float64 (the second check of that file's rule). The
    Cholesky step is solved with the float32 factor and rounded to
    bfloat16 (torch has no bfloat16 Cholesky solve; the JAX solver rounds
    the factor and solves in bfloat16)."""
    rng = np.random.default_rng(0)
    keyed = {"itemA": synth_rows(rng, 60, n_feat=5),
             "itemB": synth_rows(rng, 200, n_feat=9)}
    kw = dict(intercept_lambdas=[1.0, 5.0], default_lambdas=[2.0],
              compute_var=True, liblinear_epsilon=1e-5, solver=solver)
    want64, wantbf = (jitem.train_item_models(
        keyed, jitem.ItemConfig(dtype=dt, **kw))
        for dt in (jnp.float64, jnp.bfloat16))
    got = titem.train_item_models(
        keyed, titem.ItemConfig(dtype=torch.bfloat16, **kw), device="cpu")
    for field in ("models", "posterior_var"):
        g, b, w = (getattr(r, field) for r in (got, wantbf, want64))
        assert sorted(g) == sorted(b) == sorted(w)
        gf, bf, wf = _flat(g), _flat(b), _flat(w)
        bound = 2 * max(np.abs(bf - wf).max(), 2.0 ** -8 * np.abs(wf).max())
        assert np.isfinite(gf).all()
        assert np.abs(gf - bf).max() <= bound, field
        assert np.abs(gf - wf).max() <= bound, field
        # the port's own distance from float64, held to twice what it
        # measured (0.14% of max|w| for the models, 0.32% for the
        # variances; JAX's bfloat16 lands 6-8% away)
        assert np.abs(gf - wf).max() <= 2 * {"models": 1.5e-3,
                                             "posterior_var": 3.2e-3}[
            field] * np.abs(wf).max(), field


@pytest.mark.parametrize("solver", SOLVERS)
def test_item_grid_keys_and_values(solver):
    rng = np.random.default_rng(0)
    keyed = {"itemA": synth_rows(rng, 60, n_feat=5),
             "itemB": synth_rows(rng, 200, n_feat=9)}  # different bucket
    jcfg, tcfg = configs(intercept_lambdas=[1.0, 5.0], default_lambdas=[2.0],
                         compute_var=True, liblinear_epsilon=1e-5,
                         solver=solver)
    got = titem.train_item_models(keyed, tcfg, device="cpu")
    assert set(got.models) == {
        "1.0:2.0#itemA", "5.0:2.0#itemA", "1.0:2.0#itemB", "5.0:2.0#itemB"}
    assert_results_close(got, jitem.train_item_models(keyed, jcfg))
    assert [s["shape"] for s in got.solver_stats] == [(64, 8, 8),
                                                      (256, 16, 16)]
    assert all(s["problems"] == 2 and s["newton_trips"] > 0
               for s in got.solver_stats)


@pytest.mark.parametrize("solver", SOLVERS)
def test_item_intercept_prior_mean_map(solver):
    rows = [{"response": 1, "features": [], "weight": 0.0, "offset": 0.0}
            for _ in range(8)]  # zero-weight rows: posterior = prior
    keyed = {"camp1": rows, "camp2": rows}
    jcfg, tcfg = configs(intercept_lambdas=[2.0], default_lambdas=[2.0],
                         intercept_default_prior_mean=-1.0,
                         intercept_prior_mean_map={"camp2": 3.0},
                         solver=solver)
    got = titem.train_item_models(keyed, tcfg, device="cpu")
    assert got.models["2.0:2.0#camp1"].intercept == pytest.approx(-1.0,
                                                                  abs=1e-8)
    assert got.models["2.0:2.0#camp2"].intercept == pytest.approx(3.0,
                                                                  abs=1e-8)
    assert_results_close(got, jitem.train_item_models(keyed, jcfg))


def test_item_lambda_map_absent_feature_prior_var():
    rng = np.random.default_rng(2)
    keyed = {"i": synth_rows(rng, 50, n_feat=4)}
    jcfg, tcfg = configs(intercept_lambdas=[1.0], default_lambdas=[1.0],
                         lambda_map={"not_in_data": 4.0, "f1": 9.0},
                         compute_var=True)
    got = titem.train_item_models(keyed, tcfg, device="cpu")
    pv = got.posterior_var["1.0:1.0#i"]
    assert pv.coefficients["not_in_data"] == pytest.approx(0.25)
    assert_results_close(got, jitem.train_item_models(keyed, jcfg))


def test_item_full_cov_matches_jax_and_diag():
    rng = np.random.default_rng(3)
    keyed = {"i": synth_rows(rng, 120, n_feat=6),
             "j": synth_rows(rng, 30, n_feat=3)}
    base = dict(intercept_lambdas=[1.0], default_lambdas=[2.0, 6.0],
                compute_var=True)
    _j, tcfg_d = configs(**base)
    jcfg_f, tcfg_f = configs(full_cov=True, **base)
    r_d = titem.train_item_models(keyed, tcfg_d, device="cpu")
    r_f = titem.train_item_models(keyed, tcfg_f, device="cpu")
    want = jitem.train_item_models(keyed, jcfg_f)
    assert_results_close(r_f, want)
    assert set(r_f.covariances) == set(want.covariances)
    for key, cov in want.covariances.items():
        assert set(r_f.covariances[key]) == set(cov)
        for pair, v in cov.items():
            np.testing.assert_allclose(r_f.covariances[key][pair], v,
                                       rtol=1e-5, atol=1e-10)
    key = "1.0:2.0#i"
    # full covariance diagonal >= 1/H_kk (Schur)
    for name, v_diag in r_d.posterior_var[key].coefficients.items():
        assert r_f.posterior_var[key].coefficients[name] >= v_diag * 0.999
    cov = r_f.covariances[key]
    for a in list(r_f.models[key].coefficients)[:3]:
        for b in list(r_f.models[key].coefficients)[:3]:
            assert cov[(a, b)] == pytest.approx(cov[(b, a)], rel=1e-8)


def test_item_model_files_cross_the_two_packages(tmp_path):
    """write_item_models of either package reads back in the other, and a
    JAX ItemResult converts into the port's."""
    rng = np.random.default_rng(4)
    keyed = {"x": synth_rows(rng, 30, n_feat=3),
             "y": synth_rows(rng, 40, n_feat=3)}
    jcfg, tcfg = configs(intercept_lambdas=[1.0], default_lambdas=[1.0],
                         compute_var=True)
    got = titem.train_item_models(keyed, tcfg, device="cpu")
    want = jitem.train_item_models(keyed, jcfg)
    tpath, jpath = str(tmp_path / "t.avro"), str(tmp_path / "j.avro")
    titem.write_item_models(tpath, got)
    jitem.write_item_models(jpath, want)
    conv = item_models_from_jax(want)
    assert_results_close(got, conv)
    cpath = str(tmp_path / "c.avro")
    titem.write_item_models(cpath, conv)
    for read in (tavro.read_records, javro.read_records):
        t_recs, j_recs, c_recs = read(tpath), read(jpath), read(cpath)
        assert [r["key"] for r in t_recs] == [r["key"] for r in j_recs] \
            == ["1.0:1.0#x", "1.0:1.0#y"]
        assert c_recs == j_recs
        for t, j in zip(t_recs, j_recs):
            assert any(f["name"] == INTERCEPT_NAME for f in t["model"])
            assert t["posteriorVar"]
            for field in ("model", "posteriorVar"):
                assert [(f["name"], f["term"]) for f in t[field]] == \
                    [(f["name"], f["term"]) for f in j[field]]
                np.testing.assert_allclose(
                    [f["value"] for f in t[field]],
                    [f["value"] for f in j[field]], rtol=1e-5, atol=1e-7)


def test_item_covariance_persistence(tmp_path):
    rng = np.random.default_rng(6)
    keyed = {"i": synth_rows(rng, 100, n_feat=5)}
    jcfg, tcfg = configs(intercept_lambdas=[1.0], default_lambdas=[2.0],
                         compute_var=True, full_cov=True)
    result = titem.train_item_models(keyed, tcfg, device="cpu")
    path = str(tmp_path / "cov.avro")
    titem.write_item_covariances(path, result)
    names, cov = titem.read_item_covariances(path)["1.0:2.0#i"]
    assert names[0] == INTERCEPT_NAME
    np.testing.assert_allclose(cov, cov.T, atol=1e-6)
    assert np.all(np.linalg.eigvalsh(cov) > -1e-6)
    pv = result.posterior_var["1.0:2.0#i"]
    assert cov[0, 0] == pytest.approx(pv.intercept, rel=1e-4)
    for i, name in enumerate(names[1:], start=1):
        assert cov[i, i] == pytest.approx(pv.coefficients[name], rel=1e-4)
    # the JAX package reads the port's file, and the reverse
    jnames, jcov = jitem.read_item_covariances(path)["1.0:2.0#i"]
    assert jnames == names
    np.testing.assert_array_equal(jcov, cov)
    jpath = str(tmp_path / "jcov.avro")
    jitem.write_item_covariances(jpath, jitem.train_item_models(keyed, jcfg))
    _n, back = titem.read_item_covariances(jpath)["1.0:2.0#i"]
    np.testing.assert_allclose(back, cov, rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="full_cov"):
        titem.write_item_covariances(path, titem.ItemResult({}, {}))


def _columnar_case():
    rng = np.random.default_rng(7)
    keyed = {"a": synth_rows(rng, 60, n_feat=5),
             "b": synth_rows(rng, 200, n_feat=9),
             "c": synth_rows(rng, 17, n_feat=3),
             "d": synth_rows(rng, 60, n_feat=5)}
    # in-row duplicate combining + weights/offsets + empty rows
    keyed["a"][0]["features"].append(keyed["a"][0]["features"][0])
    keyed["b"][3]["weight"] = 2.5
    keyed["b"][4]["offset"] = -0.7
    keyed["c"][2]["features"] = []
    kw = dict(intercept_lambdas=[0.5, 2.0], default_lambdas=[1.0],
              compute_var=True, lambda_map={"f1": 25.0},
              intercept_prior_mean_map={"b": 0.3},
              intercept_default_prior_mean=-0.1, positive_weight=1.5,
              liblinear_epsilon=1e-10)
    jdec = _decoded_from_keyed(keyed)
    assert isinstance(jdec, JDecodedRows)
    tdec = titem.DecodedRows(**{f: getattr(jdec, f)
                                for f in titem.DecodedRows._fields})
    return keyed, kw, jdec, tdec


def test_packers_match_jax():
    """Both packers fill the same buckets as the JAX package's, bit for
    bit (float32 values, labels, weights and offsets included)."""
    keyed, kw, jdec, tdec = _columnar_case()
    jcfg, tcfg = configs(**kw)
    for jp, tp in ((jitem._pack_buckets_rows(keyed, jcfg),
                    titem._pack_buckets_rows(keyed, tcfg)),
                   (jitem.pack_buckets_columnar(jdec, jcfg),
                    titem.pack_buckets_columnar(tdec, tcfg))):
        assert [b[0] for b in tp] == [b[0] for b in jp]
        for (_s, tarr, tmeta), (_s2, jarr, jmeta) in zip(tp, jp):
            assert tmeta == jmeta
            assert set(tarr) == set(jarr)
            for k, v in jarr.items():
                assert tarr[k].dtype == v.dtype, k
                np.testing.assert_array_equal(tarr[k], v, k)
    assert titem._bucket_dim(1) == 8 and titem._bucket_dim(9) == 16


@pytest.mark.parametrize("solver", SOLVERS)
def test_item_columnar_parity(solver):
    keyed, kw, jdec, tdec = _columnar_case()
    jcfg, tcfg = configs(solver=solver, **kw)
    r_rows = titem.train_item_models(keyed, tcfg, device="cpu")
    r_col = titem.train_item_models_columnar(tdec, tcfg, device="cpu")
    # the two packings place features in different k-slots: same math,
    # another summation order
    assert_models_close(r_col.models, r_rows.models, rtol=1e-7, atol=1e-10)
    assert_models_close(r_col.posterior_var, r_rows.posterior_var, rtol=1e-6)
    assert_results_close(r_col, jitem.train_item_models_columnar(jdec, jcfg))
    assert_results_close(r_rows, jitem.train_item_models(keyed, jcfg))


def test_item_float32_default_and_errors():
    rng = np.random.default_rng(11)
    keyed = {f"k{i}": synth_rows(rng, 40, n_feat=5) for i in range(6)}
    cfg32 = titem.ItemConfig(intercept_lambdas=[1.0],
                             default_lambdas=[1.0, 4.0], compute_var=True,
                             full_cov=True)
    assert cfg32.dtype == torch.float32
    r32 = titem.train_item_models(keyed, cfg32, device="cpu")
    _j, cfg64 = configs(intercept_lambdas=[1.0], default_lambdas=[1.0, 4.0],
                        compute_var=True, full_cov=True,
                        liblinear_epsilon=1e-8)
    r64 = titem.train_item_models(keyed, cfg64, device="cpu")
    assert_models_close(r32.models, r64.models, rtol=0, atol=2e-2)
    assert all(v.intercept > 0 for v in r32.posterior_var.values())
    with pytest.raises(ValueError, match="unknown solver"):
        titem.train_item_models(keyed, titem.ItemConfig(solver="lbfgs"),
                                device="cpu")
    with pytest.raises(ValueError, match="item key column"):
        titem.pack_buckets_columnar(
            titem.DecodedRows(*[None] * 7, keys=None), cfg32)


@pytest.mark.parametrize("solver", SOLVERS)
def test_item_mesh_matches_jax_mesh(tmp_path, solver):
    """Per-item solves sharded over 3 ranks (10 items padded to 12 with
    copies of item 0, 4 a rank, gathered per bucket) against the JAX
    package on a 3-device mesh (tests/test_item.py::test_item_mesh_parity):
    with solver="tron", which takes the same steps in both packages,
    models, posterior variances and covariances to 1e-10 relative; with
    "cholesky" (float32 factorisations, rounded differently by LAPACK and
    XLA) to the module's tolerances. Every rank assembles the same result,
    solver stats included, equal to the port's own run without a mesh: a
    bucket counts all its G * I problems, and its Newton trips (the
    slowest rank's) are the unsharded run's."""
    import jax

    from mlease_tpu.parallel import make_mesh
    rng = np.random.default_rng(13)
    keyed = {f"k{i}": synth_rows(rng, 40, n_feat=5) for i in range(10)}
    kw = dict(intercept_lambdas=[1.0], default_lambdas=[1.0, 4.0],
              compute_var=True, full_cov=True, solver=solver)
    jcfg, tcfg = configs(**kw)
    want = jitem.train_item_models(keyed, jcfg,
                                   mesh=make_mesh(jax.devices("cpu"), n=3))
    per_rank = launch([("item", "item", dict(
        keyed=keyed, mesh=3, config=dict(kw, dtype="float64")))], 3,
        tmp_path)["item"]
    for r in per_rank[1:]:
        assert r == per_rank[0]
    got = per_rank[0]
    plain = titem.train_item_models(keyed, tcfg, device="cpu")
    assert [(s["shape"], s["problems"], s["newton_trips"])
            for s in got["stats"]] == [
        (s["shape"], s["problems"], s["newton_trips"])
        for s in plain.solver_stats]
    assert sum(s["problems"] for s in got["stats"]) == 2 * len(keyed)
    rtol = 1e-10 if solver == "tron" else 1e-6
    for field, want_m, plain_m in (("models", want.models, plain.models),
                                   ("pvar", want.posterior_var,
                                    plain.posterior_var)):
        assert set(got[field]) == set(want_m) == set(plain_m)
        for key, m in want_m.items():
            icpt, coefs = got[field][key]
            assert set(coefs) == set(m.coefficients), key
            np.testing.assert_allclose(
                [icpt] + [coefs[f] for f in sorted(coefs)],
                [m.intercept] + [m.coefficients[f] for f in sorted(coefs)],
                rtol=rtol, atol=1e-12 if solver == "tron" else 1e-8)
            pm = plain_m[key]
            np.testing.assert_allclose(
                [icpt] + [coefs[f] for f in sorted(coefs)],
                [pm.intercept] + [pm.coefficients[f] for f in sorted(coefs)],
                rtol=1e-10, atol=1e-12)
    assert set(got["cov"]) == set(want.covariances)
    for key, c in want.covariances.items():
        assert set(got["cov"][key]) == set(c)
        np.testing.assert_allclose(
            [got["cov"][key][p] for p in sorted(c)],
            [c[p] for p in sorted(c)], rtol=rtol,
            atol=1e-12 if solver == "tron" else 1e-8)
