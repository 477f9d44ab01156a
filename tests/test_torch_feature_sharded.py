"""The port's feature-sharded trainer (mlease_tpu_torch.train.
feature_sharded, core/feature_shard.py, tron_multi(group=)) against the JAX
package's, float64 on the CPU: block x feat gloo ranks of the port
(tests/torch_mesh_worker.py, no JAX) against the same grid of the
conftest's virtual CPU devices, rows from tests/test_admm.py::synth_rows.

Tolerances: z and u to 1e-8 * max|z|, diffs to 1e-8, with equal Newton and
CG trip counts per iteration (the shards' partial scores and dots are
summed in another order, ~1e-15 a solve); sample logliks 1e-9. Every rank
(those past the mesh included) returns the same result bit for bit: the
lock-step loops of a feat group see the same all_reduced scalars.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core import feature_shard as jfs
from mlease_tpu.parallel import cpu_devices
from mlease_tpu.parallel.mesh import make_mesh_2d
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.feature_sharded import FeatureShardedAdmmTrainer as JFS
from mlease_tpu_torch.core import feature_shard as tfs

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)

BASE = dict(lambdas=[1.0, 10.0], num_iters=5, multi_rhs=True, pcg=True,
            flat_blocks=False)


def rows_of(seed, n):
    return synth_rows(np.random.default_rng(seed), n)


# name -> (world, grid, seed, rows, nblocks, config extra, with test rows)
CASES = {
    "grid-2x2": (4, (2, 2), 2, 240, 3, {}, False),
    "grid-1x4": (4, (1, 4), 2, 240, 3, {}, False),
    "grid-4x1": (4, (4, 1), 2, 240, 3, {}, False),
    "grid-1x2": (2, (1, 2), 2, 240, 3, {}, False),
    "grid-2x1": (2, (2, 1), 2, 240, 3, {}, False),
    "l1-lambda-map": (2, (1, 2), 3, 200, 2,
                      dict(lambdas=[0.5, 4.0], num_iters=4, regularizer=1,
                           lambda_map="first"), False),
    "loglik": (2, (1, 2), 4, 260, 2,
               dict(lambdas=[1.0, 100.0], num_iters=4,
                    test_loglik_per_iter=True), True),
    "sit-out-1x2": (3, (1, 2), 2, 240, 3, dict(num_iters=3), False),
}


def problem(name):
    world, grid, seed, n, nb, extra, with_test = CASES[name]
    rows = rows_of(seed, n)
    test_rows = None
    if with_test:
        rows, test_rows = rows[:200], rows[200:]
    cfg = dict(BASE, **extra)
    blocks = ([rows[:100], rows[100:]] if nb == 2
              else [rows[i::nb] for i in range(nb)])
    vocab = build_vocab([r for b in blocks for r in b])
    if cfg.get("lambda_map") == "first":
        cfg["lambda_map"] = {next(k for k in vocab.names
                                  if k != "(INTERCEPT)"): 25.0}
    return world, grid, blocks, vocab, cfg, test_rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in sorted({c[0] for c in CASES.values()}):
        cases = []
        for name in (n for n, c in CASES.items() if c[0] == world):
            _w, grid, blocks, _v, cfg, test_rows = problem(name)
            cases.append((name, "fs", dict(
                blocks=blocks, grid=grid, test_rows=test_rows,
                config=dict(cfg, dtype="float64"))))
        out.update(launch(cases, world, tmp_path_factory.mktemp(
            f"fs{world}"), timeout=150))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_feature_sharded_matches_jax(runs, name):
    """Grids (2x2, 1x4, 4x1, 1x2, 2x1; 1x2 on 3 ranks, the third sitting
    out), L1 with lambda.map, the sample loglik and best model."""
    world, grid, blocks, vocab, cfg, test_rows = problem(name)
    per_rank = runs[name]
    assert len(per_rank) == world
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r["z"], per_rank[0]["z"])
        np.testing.assert_array_equal(r["u"], per_rank[0]["u"])
        assert r["solver_stats"] == per_rank[0]["solver_stats"]
        assert r["diff_history"] == per_rank[0]["diff_history"]
    data = pack_blocks(blocks, vocab)
    mesh = make_mesh_2d(cpu_devices(), block=grid[0], feat=grid[1])
    want = JFS(data, vocab, JConfig(dtype=jnp.float64, **cfg),
               test_rows=test_rows, mesh=mesh).run()
    got = per_rank[0]
    atol = 1e-8 * float(np.abs(want.z).max())
    assert got["iterations"] == want.iterations
    np.testing.assert_allclose(got["z"], want.z, rtol=0, atol=atol)
    np.testing.assert_allclose(got["u"], want.u, rtol=0, atol=atol)
    assert got["solver_stats"] == [{k: int(v) for k, v in s.items()}
                                   for s in want.solver_stats]
    for a, b in zip(got["diff_history"], want.diff_history):
        assert list(a) == list(b)
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-8, abs=1e-12)
    assert got["best_lambda"] == want.best_lambda
    assert len(got["sample_loglik_history"]) == \
        len(want.sample_loglik_history)
    for a, b in zip(got["sample_loglik_history"],
                    want.sample_loglik_history):
        assert (a["lambda"], a["iter"]) == (b["lambda"], b["iter"])
        assert a["testLoglik"] == pytest.approx(b["testLoglik"], abs=1e-9)
    if test_rows is not None:
        assert got["best_loglik"] == pytest.approx(want.best_loglik,
                                                   abs=1e-9)


def test_shard_vectors_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 11))
    for S in (1, 2, 4, 5):
        nl = (11 + S - 1) // S
        got = tfs.shard_feature_vector(v, S, nl)
        np.testing.assert_array_equal(got, jfs.shard_feature_vector(v, S, nl))
        for g in range(11):
            np.testing.assert_array_equal(got[g % S, :, g // S], v[:, g])
        np.testing.assert_array_equal(tfs.unshard_feature_vector(got, 11), v)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_shard_features_matches_jax(S):
    rows = rows_of(1, 60)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[:30], rows[30:]], vocab)
    got = tfs.with_intercept(tfs.shard_features(data, S),
                             vocab.intercept_index)
    want = jfs.with_intercept(jfs.shard_features(data, S),
                              vocab.intercept_index)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    from mlease_tpu.core.dataset import to_hybrid
    with pytest.raises(ValueError, match="ELL layout"):
        tfs.shard_features(to_hybrid(data, 2), S)


def test_pipeline_feature_shards_key(tmp_path):
    """mesh.feature.shards=2 through the port's pipeline on 2 ranks (a
    1 x 2 mesh) against the JAX pipeline with the same key (its virtual
    devices: a 4 x 2 mesh), on examples/data/breast-cancer: final models
    and z to 1e-8."""
    from mlease_tpu.core.linear_model import read_model_file
    from mlease_tpu.train.pipeline import run_regression_pipeline
    from mlease_tpu.utils.config import JobConfig

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(repo, "examples", "data", "breast-cancer")
    props = dict(JobConfig.from_file(os.path.join(
        repo, "examples", "data", "breast-cancer.job")))
    props.update({"input.paths": os.path.join(data, "train"),
                  "test.path": os.path.join(data, "test"),
                  "num.iters": "3", "mesh.feature.shards": "2",
                  "force.output.overwrite": "true"})
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = run_regression_pipeline(JobConfig(dict(
        props, **{"output.base.path": out_j})))
    got = launch([("p", "pipeline", dict(props=dict(
        props, **{"output.base.path": out_t})))], 2, tmp_path / "ranks",
        timeout=150)["p"]
    np.testing.assert_array_equal(got[1]["z"], got[0]["z"])
    atol = 1e-8 * float(np.abs(want.z).max())
    np.testing.assert_allclose(got[0]["z"], want.z, rtol=0, atol=atol)
    mj = read_model_file(os.path.join(out_j, "final-model"))
    mt = read_model_file(os.path.join(out_t, "final-model"))
    assert sorted(mj) == sorted(mt)
    for k in mj:
        assert mt[k].intercept == pytest.approx(mj[k].intercept, abs=atol)
        for f, w in mj[k].coefficients.items():
            assert mt[k].coefficients[f] == pytest.approx(w, abs=atol)


def test_sample_loglik_of_shard_and_sharded_passes(tmp_path):
    """On 2 ranks (1 x 2 feature shards): sample_loglik(z) of a rank's z
    shard alone gathers it and equals sample_loglik(z, z_host) and the JAX
    trainer's; xv, fun and hv with group= on the shards equal the JAX
    functions on the unsharded stacked problem within 1e-12."""
    import mlease_tpu.ops.tron_multi as jtm
    from mlease_tpu.ops.tron_multi import stack_blocks

    rows = rows_of(4, 260)
    rows, test_rows = rows[:200], rows[200:]
    blocks = [rows[:100], rows[100:]]
    vocab = build_vocab(rows)
    data = pack_blocks(blocks, vocab)
    cfg = dict(BASE, lambdas=[1.0, 100.0])
    B, n, L = data.nblocks, data.dim, 2
    rng = np.random.default_rng(5)
    R = B * data.padded_rows
    p = dict(blocks=blocks, grid=(1, 2), test_rows=test_rows,
             config=dict(cfg, dtype="float64"),
             z=rng.normal(size=(L, n)) * 0.3,
             prior_mean=rng.normal(size=(L, B * n)) * 0.05,
             rho=np.array([0.5, 4.0]),
             W=rng.normal(size=(B * n, L)) * 0.3,
             S=rng.normal(size=(B * n, L)), Dm=rng.random(size=(R, L)))
    got = launch([("api", "fs_api", p)], 2, tmp_path, timeout=120)["api"]

    mesh = make_mesh_2d(cpu_devices(), block=1, feat=2)
    want_ll = JFS(data, vocab, JConfig(dtype=jnp.float64, **cfg),
                  test_rows=test_rows, mesh=mesh).sample_loglik(None, p["z"])
    f64 = {k: jnp.asarray(np.asarray(getattr(data, k), np.float64))
           for k in ("values", "y", "weight", "offset")}
    jp = stack_blocks(jnp.asarray(data.indices), f64["values"], f64["y"],
                      f64["weight"], f64["offset"], (None,) * 8,
                      jnp.asarray(p["prior_mean"].reshape(L, B, n)),
                      jnp.asarray(p["rho"]))
    want_xv = np.asarray(jtm.xv(jp, jnp.asarray(p["W"])))
    want_fun = np.asarray(jtm.fun(jp, jnp.asarray(p["W"])))
    want_hv = np.asarray(jtm.hv(jp, jnp.asarray(p["Dm"]),
                                jnp.asarray(p["S"])))

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(b).max()))
    for r in got:
        np.testing.assert_array_equal(r["ll_z"], r["ll_host"])
        np.testing.assert_allclose(r["ll_z"], want_ll, rtol=0, atol=1e-9)
        close(r["xv"], want_xv)
        close(r["fun"], want_fun)
    nl = got[0]["n_local"]
    hv_fs = np.stack([r["hv"].reshape(B, nl, L).transpose(2, 0, 1)
                      for r in sorted(got, key=lambda r: r["shard"])])
    close(tfs.unshard_feature_vector(hv_fs, n),
          want_hv.reshape(B, n, L).transpose(2, 0, 1))
