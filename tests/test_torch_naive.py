"""The port's naive trainer (mlease_tpu_torch.train.naive) against the JAX
package's, float64 on the CPU: the cases of tests/test_naive.py, each run
through both packages on the same rows; the mesh one on gloo ranks of the
port (tests/torch_mesh_worker.py) against the JAX package's virtual
devices.

Every comparison is the same branch on both sides: the flat multi-RHS solve
(the default), the per-key multi-RHS solve (flat_blocks=False) and the
batched reference TRON over (lambda x key) lanes (multi_rhs=False).
Tolerance: every model's coefficients to 1e-8 * max|w| (each solve agrees to
about 1e-12: tests/test_torch_tron_multi.py, test_torch_tron.py), with the
same model keys, skipped keys and mean-model keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab as jax_build_vocab
from mlease_tpu.train.naive import NaiveConfig as JaxNaiveConfig
from mlease_tpu.train.naive import train_naive as jax_train_naive
from mlease_tpu_torch.core import build_vocab
from mlease_tpu_torch.train import NaiveConfig, NaiveResult, train_naive

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)

BRANCHES = {"flat": {}, "per_key": {"flat_blocks": False},
            "lanes": {"multi_rhs": False}}


def run_both(keyed, vocab_rows=None, **kw):
    """The same config through both packages (vocabularies built from the
    same rows when given, else by train_naive itself)."""
    jv = tv = None
    if vocab_rows is not None:
        jv, tv = jax_build_vocab(vocab_rows), build_vocab(vocab_rows)
    want = jax_train_naive(keyed, JaxNaiveConfig(dtype=jnp.float64, **kw),
                           vocab=jv)
    got = train_naive(keyed, NaiveConfig(dtype=torch.float64, **kw),
                      vocab=tv, device="cpu")
    return got, want


def assert_models_match(got, want):
    assert isinstance(got, NaiveResult)
    assert sorted(got.models) == sorted(want.models)
    assert got.skipped_keys == want.skipped_keys
    scale = max(max([abs(m.intercept) for m in want.models.values()]
                    + [abs(v) for m in want.models.values()
                       for v in m.coefficients.values()]), 1e-300)
    pairs = [(got.models, want.models)]
    if want.mean_models is not None:
        assert sorted(got.mean_models) == sorted(want.mean_models)
        pairs.append((got.mean_models, want.mean_models))
    else:
        assert got.mean_models is None
    for g, w in pairs:
        for key, wm in w.items():
            gm = g[key]
            assert sorted(gm.coefficients) == sorted(wm.coefficients), key
            assert abs(gm.intercept - wm.intercept) <= 1e-8 * scale, key
            for name, v in wm.coefficients.items():
                assert abs(gm.coefficients[name] - v) <= 1e-8 * scale, \
                    (key, name)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_naive_matches_independent_fits(branch):
    """tests/test_naive.py::test_naive_matches_independent_fits: two keys,
    two lambdas, tight tolerance."""
    rng = np.random.default_rng(0)
    keyed = {"0": synth_rows(rng, 120), "1": synth_rows(rng, 150)}
    got, want = run_both(keyed, keyed["0"] + keyed["1"], lambdas=[1.0, 4.0],
                         liblinear_epsilon=1e-5, **BRANCHES[branch])
    assert set(got.models) == {"1.0#0", "1.0#1", "4.0#0", "4.0#1"}
    assert_models_match(got, want)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_naive_mean_model(branch):
    """compute.model.mean: the per-lambda mean of the key models."""
    rng = np.random.default_rng(1)
    keyed = {str(i): synth_rows(rng, 80) for i in range(3)}
    rows = [r for rs in keyed.values() for r in rs]
    got, want = run_both(keyed, rows, lambdas=[2.0, 0.5],
                         compute_model_mean=True, **BRANCHES[branch])
    assert_models_match(got, want)
    manual = sum(got.models[f"2.0#{k}"].intercept for k in keyed) / 3
    assert got.mean_models["2.0"].intercept == pytest.approx(manual)


def test_naive_data_size_threshold():
    rng = np.random.default_rng(2)
    keyed = {"big": synth_rows(rng, 100), "small": synth_rows(rng, 3)}
    got, want = run_both(keyed, lambdas=[1.0], data_size_threshold=10,
                         compute_model_mean=True)
    assert got.skipped_keys == ["small"]
    assert set(got.models) == {"1.0#big"}
    assert_models_match(got, want)
    # every key under the threshold: no model, an empty mean
    none = train_naive(keyed, NaiveConfig(dtype=torch.float64,
                                          data_size_threshold=1000,
                                          compute_model_mean=True),
                       device="cpu")
    assert (none.models, none.mean_models) == ({}, {})
    assert none.skipped_keys == ["big", "small"]


@pytest.mark.parametrize("branch", ["flat", "lanes"])
def test_naive_lambda_map_and_prior_mean(branch):
    rng = np.random.default_rng(3)
    rows = synth_rows(rng, 200)
    got, want = run_both({"0": rows}, rows, lambdas=[1.0, 3.0],
                         lambda_map={"f0": 1000.0}, prior_mean=0.05,
                         positive_weight=2.0, **BRANCHES[branch])
    assert_models_match(got, want)


def test_naive_no_intercept_mode():
    rng = np.random.default_rng(4)
    rows = synth_rows(rng, 100)
    got, want = run_both({"0": rows}, lambdas=[1.0], has_intercept=False)
    assert got.models["1.0#0"].intercept == 0.0
    assert_models_match(got, want)


def test_naive_flat_matches_vmapped():
    """Within the port: the flat and per-key solves reach the same models to
    solver tolerance (the JAX test's tolerance)."""
    rng = np.random.default_rng(12)
    keyed = {str(i): synth_rows(rng, 60 + 10 * i) for i in range(3)}
    vocab = build_vocab([r for rows in keyed.values() for r in rows])
    base = dict(lambdas=[1.0, 4.0], dtype=torch.float64,
                liblinear_epsilon=1e-9)
    res_v = train_naive(keyed, NaiveConfig(flat_blocks=False, **base),
                        vocab=vocab, device="cpu")
    res_f = train_naive(keyed, NaiveConfig(flat_blocks=True, **base),
                        vocab=vocab, device="cpu")
    assert set(res_f.models) == set(res_v.models)
    for k in res_v.models:
        np.testing.assert_allclose(res_f.models[k].to_dense(vocab),
                                   res_v.models[k].to_dense(vocab),
                                   rtol=1e-3, atol=1e-6)


def test_naive_intercept_key_redirects_unpenalized_variance():
    """intercept.key names the feature that gets the 1e5 prior variance
    (RegressionNaiveTrain.java:146,342), through both packages."""
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(300):
        x = rng.normal(size=2)
        p = 1 / (1 + np.exp(-(2.0 * x[0] + 3.0)))
        rows.append({"response": int(rng.random() < p),
                     "features": [("f0", float(x[0])), ("f1", float(x[1]))],
                     "weight": 1.0, "offset": 0.0})
    base, base_j = run_both({"0": rows}, lambdas=[50.0])
    redir, redir_j = run_both({"0": rows}, lambdas=[50.0],
                              intercept_key="f0")
    assert_models_match(base, base_j)
    assert_models_match(redir, redir_j)
    mb, mr = base.models["50.0#0"], redir.models["50.0#0"]
    assert abs(mr.coefficients["f0"]) > abs(mb.coefficients["f0"])
    assert abs(mr.intercept) < abs(mb.intercept)


def test_naive_mesh_and_card_raise(monkeypatch):
    """A mesh needs a process group (make_mesh names the launcher), and
    device="cuda" without a card raises."""
    from mlease_tpu_torch.parallel import make_mesh
    rng = np.random.default_rng(5)
    keyed = {"0": synth_rows(rng, 40)}
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_naive(keyed, NaiveConfig(dtype=torch.float64),
                    mesh=make_mesh(2, "cpu"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_naive(keyed, NaiveConfig(dtype=torch.float64))


def test_naive_on_mesh_matches_jax_mesh(tmp_path):
    """3 keys over 2 ranks (padded to 4, 2 a rank, one key solve each, the
    models gathered) in both branches that run on a mesh (per-key
    multi-RHS, flat_blocks=True included: never flat on a mesh; and the
    lanes), against the JAX package on a 2-device mesh
    (tests/test_naive.py::test_naive_on_mesh_matches_single): models and
    mean models to 1e-8 * max|w|, every rank the same, trip counts
    included; the Newton trips (the slowest rank's) equal the port's own
    run of the branch without a mesh."""
    import jax

    from mlease_tpu.parallel import make_mesh
    rng = np.random.default_rng(5)
    keyed = {str(i): synth_rows(rng, 60 + 10 * i) for i in range(3)}
    names = None
    cases = {"per_key": {"flat_blocks": True}, "lanes": {"multi_rhs": False}}
    base = dict(lambdas=[1.0, 4.0], compute_model_mean=True)
    runs = launch([(k, "naive", dict(keyed=keyed, mesh=2, config=dict(
        base, dtype="float64", **kw))) for k, kw in cases.items()], 2,
        tmp_path)
    vocab = jax_build_vocab([r for k in sorted(keyed) for r in keyed[k]])
    for name, kw in cases.items():
        per_rank = runs[name]
        for r in per_rank[1:]:
            assert r["trips"] == per_rank[0]["trips"]
            assert r["models"].keys() == per_rank[0]["models"].keys()
            for k, v in r["models"].items():
                np.testing.assert_array_equal(v, per_rank[0]["models"][k])
        got = per_rank[0]
        names = got["names"]
        assert names == vocab.names
        one = train_naive(keyed, NaiveConfig(dtype=torch.float64, **{
            **base, **kw, "flat_blocks": False}), device="cpu")
        assert got["trips"]["newton_trips"] == one.solver_stats[
            "newton_trips"]
        want = jax_train_naive(keyed, JaxNaiveConfig(dtype=jnp.float64,
                                                     **base, **kw),
                               vocab=vocab,
                               mesh=make_mesh(jax.devices("cpu"), n=2))
        assert sorted(got["models"]) == sorted(want.models)
        scale = max(np.abs(m.to_dense(vocab)).max()
                    for m in want.models.values())
        for key, m in want.models.items():
            np.testing.assert_allclose(got["models"][key], m.to_dense(vocab),
                                       rtol=0, atol=1e-8 * scale)
        for key, m in want.mean_models.items():
            np.testing.assert_allclose(got["mean"][key], m.to_dense(vocab),
                                       rtol=0, atol=1e-8 * scale)
