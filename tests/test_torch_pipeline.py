"""The port's train pipeline against the JAX package's, end to end on
examples/data/breast-cancer.job (float64, 4 blocks, lambda 0.1/1/10) with
head.size=16, both on the CPU, outputs under tmp_path.

Tolerances: per-iteration sample logliks to 1e-8 and final models to 1e-7
after 20 iterations (the solves agree to ~1e-12 per iteration; see
tests/test_torch_admm.py).
"""

import json
import os
import subprocess
import sys

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlease_tpu.core.linear_model import read_model_file
from mlease_tpu.io import avro
from mlease_tpu.train.pipeline import run_regression_pipeline as jax_pipeline
from mlease_tpu.utils.config import JobConfig
from mlease_tpu_torch.train.pipeline import \
    run_regression_pipeline as torch_pipeline

from torch_mesh_worker import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = os.path.join(REPO, "examples", "data", "breast-cancer.job")
DATA = os.path.join(REPO, "examples", "data", "breast-cancer")


def job(out: str, **extra) -> dict:
    """The job's keys with its paths pointed at this checkout and `out`."""
    props = dict(JobConfig.from_file(JOB))
    props.update({"input.paths": os.path.join(DATA, "train"),
                  "test.path": os.path.join(DATA, "test"),
                  "output.base.path": out, "head.size": "16"})
    props.update(extra)
    return props


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_j = str(tmp_path_factory.mktemp("jax-out"))
    out_t = str(tmp_path_factory.mktemp("torch-out"))
    res_j = jax_pipeline(JobConfig(job(out_j)))
    res_t = torch_pipeline(JobConfig(job(out_t)), device="cpu")
    return (out_j, res_j), (out_t, res_t)


def tree(root):
    """Relative paths of the output files that carry results (checkpoints
    and prepared rows are per-run state)."""
    out = set()
    for dirpath, _dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.split(os.sep)[0] in ("checkpoint", "tmp-data"):
            continue
        out.update(os.path.join(rel, f) for f in files)
    return out


def test_same_output_layout(runs):
    (out_j, res_j), (out_t, res_t) = runs
    assert tree(out_t) == tree(out_j)
    for rel in ("final-model/part-r-00000.avro", "lambda-rho/part-r-00000.avro",
                "sample-test-loglik/iteration-1.avro",
                "test/lambda-0.1/_loglik/part-r-00000.avro",
                "test/lambda-10.0/part-r-00000.avro",
                f"best-model/best-iteration-{res_t.iterations}.avro"):
        assert os.path.exists(os.path.join(out_t, rel)), rel
    assert res_t.iterations == res_j.iterations
    assert res_t.best_lambda == res_j.best_lambda


def test_same_logliks_and_models(runs):
    (out_j, res_j), (out_t, res_t) = runs
    ll_dir = "sample-test-loglik"
    files = sorted(os.listdir(os.path.join(out_j, ll_dir)))
    assert files == sorted(os.listdir(os.path.join(out_t, ll_dir)))
    for name in files:
        want = avro.read_records(os.path.join(out_j, ll_dir, name))
        got = avro.read_records(os.path.join(out_t, ll_dir, name))
        assert [(r["lambda"], r["iter"]) for r in got] == \
            [(r["lambda"], r["iter"]) for r in want]
        np.testing.assert_allclose([r["testLoglik"] for r in got],
                                   [r["testLoglik"] for r in want],
                                   rtol=0, atol=1e-8)
    for sub in ("final-model", "best-model"):
        mj = read_model_file(os.path.join(out_j, sub))
        mt = read_model_file(os.path.join(out_t, sub))
        assert sorted(mj) == sorted(mt)
        for key in mj:
            cj, ct = mj[key].coefficients, mt[key].coefficients
            assert sorted(cj) == sorted(ct)
            np.testing.assert_allclose([ct[f] for f in sorted(cj)],
                                       [cj[f] for f in sorted(cj)],
                                       rtol=0, atol=1e-7)
    np.testing.assert_allclose(res_t.z, res_j.z, rtol=0, atol=1e-7)


def test_cli_device_cpu_smoke(tmp_path):
    props = job(str(tmp_path / "out"), **{"num.iters": "2"})
    job_file = tmp_path / "bc.job"
    job_file.write_text("".join(f"{k}={v}\n" for k, v in props.items()))
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
    proc = subprocess.run(
        [sys.executable, "-m", "mlease_tpu_torch", "train", str(job_file),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["iterations"] == 2 and summary["device"] == "cpu"
    assert summary["models"] == ["0.1", "1.0", "10.0"]
    # the plain version runs on the CPU: the kernel is never launched
    assert summary["kernel_launches"] == {"segment_sum_sorted": 0,
                                          "gram_batched": 0,
                                          "head_xv": 0, "head_xtv": 0}
    assert os.path.exists(tmp_path / "out" / "final-model" /
                          "part-r-00000.avro")


def _capture_z0(monkeypatch, targets):
    """Record the z0 each pipeline hands its trainer's run(); targets are
    (module, class name) pairs where the pipeline looks the class up."""
    seen = []
    for module, name in targets:
        cls = getattr(module, name)

        class Recording(cls):
            def run(self, *a, **kw):
                seen.append(kw.get("z0"))
                return super().run(*a, **kw)
        monkeypatch.setattr(module, name, Recording)
    return seen


def _same_models(out_t, out_j, sub, atol):
    mj = read_model_file(os.path.join(out_j, sub))
    mt = read_model_file(os.path.join(out_t, sub))
    assert sorted(mj) == sorted(mt)
    for key in mj:
        cj, ct = mj[key].coefficients, mt[key].coefficients
        assert sorted(cj) == sorted(ct), key
        np.testing.assert_allclose([ct[f] for f in sorted(cj)],
                                   [cj[f] for f in sorted(cj)],
                                   rtol=0, atol=atol)
        assert abs(mt[key].intercept - mj[key].intercept) <= atol


# the ids name the ROADMAP.md item a key once raised for (None: none)
@pytest.mark.parametrize("extra", [
    pytest.param({"use.mesh": "true"},
                 id="use.mesh=true-None"),
    pytest.param({"mesh.feature.shards": "2"},
                 id="mesh.feature.shards=2-None"),
    pytest.param({"fused.loop": "true"},
                 id="fused.loop=true-A1"),
    pytest.param({"fused.loop": "true", "checkpoint.every": "2"},
                 id="fused.loop=true-checkpoint.every=2-None"),
    pytest.param({"fused.loop": "true", "multi.rhs": "false"},
                 id="fused.loop=true-multi.rhs=false-A1b"),
    pytest.param({"fused.loop": "true", "use.mesh": "true"},
                 id="fused.loop=true-use.mesh=true-A1b"),
    pytest.param({"pcg": "head_block"},
                 id="pcg=head_block-None"),
    pytest.param({"streaming.groups": "2", "pcg": "head_block"},
                 id="streaming.groups=2-pcg=head_block-None"),
    pytest.param({"streaming.groups": "2", "flat.blocks": "false"},
                 id="streaming.groups=2-flat.blocks=false-None"),
    pytest.param({"streaming.groups": "2", "multi.rhs": "false"},
                 id="streaming.groups=2-multi.rhs=false-None")])
def test_unported_job_keys_raise(tmp_path, extra):
    """The keys that once raised here, naming their ROADMAP.md item, now
    run as the JAX pipeline runs them, to the same final models to 1e-8
    after 3 iterations: the solver modes (A1) in memory and streamed, the
    mesh (A8): use.mesh on a one-rank mesh that the pipeline starts itself
    (the JAX pipeline: its 8 virtual devices), mesh.feature.shards=2 on 2
    gloo ranks (tests/torch_mesh_worker.py; JAX: a 4 x 2 mesh), and
    fused.loop (A1's run_fused) against the JAX pipeline's fused run, the
    trip totals equal, also on the lanes solve (multi.rhs=false) and under
    use.mesh (A1b); with checkpoint.every=2 both write a checkpoint at
    each chunk end (iterations 2 and 3) and every sample-test-loglik file,
    the same entries to 1e-8. The ids keep the ROADMAP.md items that once
    raised."""
    extra = dict(extra, **{"num.iters": "3"})
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    res_j = jax_pipeline(JobConfig(job(out_j, **extra)))
    if "mesh.feature.shards" in extra:
        got = launch([("p", "pipeline", dict(props=job(out_t, **extra)))],
                     2, tmp_path / "ranks", timeout=150)["p"][0]
        res_t = SimpleNamespace(**got)
    else:
        try:
            res_t = torch_pipeline(JobConfig(job(out_t, **extra)),
                                   device="cpu")
        finally:
            if dist.is_initialized():       # use.mesh's one-rank group
                dist.destroy_process_group()
    assert res_t.iterations == res_j.iterations == 3
    if res_j.solver_stats:        # the JAX streaming trainer keeps none
        assert res_t.solver_stats == [{k: int(v) for k, v in s.items()}
                                      for s in res_j.solver_stats]
    np.testing.assert_allclose(res_t.z, res_j.z, rtol=0, atol=1e-8)
    _same_models(out_t, out_j, "final-model", 1e-8)
    if "checkpoint.every" in extra:
        for out in (out_j, out_t):
            assert sorted(os.listdir(os.path.join(out, "checkpoint"))) == [
                f"iter-{i:05d}.{ext}" for i in (2, 3)
                for ext in ("json", "npz")]
        ll_dir = "sample-test-loglik"
        names = sorted(os.listdir(os.path.join(out_t, ll_dir)))
        assert names == sorted(os.listdir(os.path.join(out_j, ll_dir))) == [
            f"iteration-{i}.avro" for i in (1, 2, 3)]
        for name in names:
            want = avro.read_records(os.path.join(out_j, ll_dir, name))
            got = avro.read_records(os.path.join(out_t, ll_dir, name))
            assert [(r["lambda"], r["iter"]) for r in got] == \
                [(r["lambda"], r["iter"]) for r in want]
            np.testing.assert_allclose([r["testLoglik"] for r in got],
                                       [r["testLoglik"] for r in want],
                                       rtol=0, atol=1e-8)


@pytest.mark.parametrize("extra", [
    {"regularizer": "2"}, {"regularizer": "1"},
    {"regularizer": "2", "streaming.groups": "2"}],
    ids=["l2", "l1", "l2-streaming"])
def test_boosted_job_matches_jax(tmp_path, monkeypatch, extra):
    """initialize.boost.rate > 0 (ROADMAP.md A4, C8). With L2 both
    pipelines fit the naive models per block, write the same
    initialModel/ records (1e-8) and start from the same mean-model z0
    (1e-8); with L1 neither warm-starts (z0 None: the run starts from zero)
    and both read the rows record by record. Then the same runs: final
    models and sample logliks (iteration 0 is z0's) to 1e-8."""
    import mlease_tpu.train.pipeline as jpl
    import mlease_tpu.train.streaming as jst
    import mlease_tpu_torch.train.pipeline as tpl
    extra = dict(extra, **{"initialize.boost.rate": "2.0", "num.iters": "3",
                           "pack.cache.dir": str(tmp_path / "cache")})
    z0_j = _capture_z0(monkeypatch, [(jpl, "AdmmTrainer"),
                                     (jst, "StreamingAdmmTrainer")])
    z0_t = _capture_z0(monkeypatch, [(tpl, "AdmmTrainer"),
                                     (tpl, "StreamingAdmmTrainer")])
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    res_j = jax_pipeline(JobConfig(job(out_j, **extra)))
    res_t = torch_pipeline(JobConfig(job(out_t, **extra)), device="cpu")
    assert len(z0_j) == len(z0_t) == 1
    assert not os.path.exists(tmp_path / "cache")      # no pack cache
    assert os.path.isdir(os.path.join(out_t, "tmp-data"))
    if extra["regularizer"] == "1":
        assert z0_j[0] is None and z0_t[0] is None
        assert not os.path.exists(os.path.join(out_t, "initialModel"))
    else:
        np.testing.assert_allclose(z0_t[0], z0_j[0], rtol=0, atol=1e-8)
        assert np.abs(z0_t[0]).max() > 0
        _same_models(out_t, out_j, "initialModel", 1e-8)
        assert len(read_model_file(os.path.join(out_t, "initialModel"))) \
            == 3 * 4        # 3 lambdas x 4 blocks
    assert tree(out_t) == tree(out_j)
    np.testing.assert_allclose(res_t.z, res_j.z, rtol=0, atol=1e-8)
    _same_models(out_t, out_j, "final-model", 1e-8)
    assert [(e["iter"], e["lambda"]) for e in res_t.sample_loglik_history] \
        == [(e["iter"], e["lambda"]) for e in res_j.sample_loglik_history]
    np.testing.assert_allclose(
        [e["testLoglik"] for e in res_t.sample_loglik_history],
        [e["testLoglik"] for e in res_j.sample_loglik_history],
        rtol=0, atol=1e-8)


STREAM_KEYS = {"streaming.groups": "2", "head.dtype": "bfloat16",
               "num.iters": "8"}


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """The breast-cancer job streamed in 2 groups with a bfloat16 head and
    a pack cache: once in the JAX pipeline, twice in the port's (the second
    a cache hit, with profile.dir set)."""
    base = tmp_path_factory.mktemp("stream")
    runs = {}
    for tag, fn, kw in (("jax", jax_pipeline, {}),
                        ("torch", torch_pipeline, {"device": "cpu"}),
                        ("torch-hit", torch_pipeline, {"device": "cpu"})):
        out = str(base / f"{tag}-out")
        extra = dict(STREAM_KEYS, **{
            "pack.cache.dir": str(base / ("jax-cache" if tag == "jax"
                                          else "torch-cache"))})
        if tag == "torch-hit":
            extra["profile.dir"] = str(base / "trace")
        runs[tag] = (out, fn(JobConfig(job(out, **extra)), **kw))
    return base, runs


def test_streaming_job_with_pack_cache_matches_jax(stream_runs):
    _base, runs = stream_runs
    (out_j, res_j), (out_t, res_t) = runs["jax"], runs["torch"]
    assert res_t.iterations == res_j.iterations == 8
    assert tree(out_t) == tree(out_j)
    ll_dir = "sample-test-loglik"
    for name in sorted(os.listdir(os.path.join(out_j, ll_dir))):
        want = avro.read_records(os.path.join(out_j, ll_dir, name))
        got = avro.read_records(os.path.join(out_t, ll_dir, name))
        np.testing.assert_allclose([r["testLoglik"] for r in got],
                                   [r["testLoglik"] for r in want],
                                   rtol=0, atol=1e-8)
    for sub in ("final-model", "best-model"):
        mj = read_model_file(os.path.join(out_j, sub))
        mt = read_model_file(os.path.join(out_t, sub))
        assert sorted(mj) == sorted(mt)
        for key in mj:
            cj, ct = mj[key].coefficients, mt[key].coefficients
            assert sorted(cj) == sorted(ct)
            np.testing.assert_allclose([ct[f] for f in sorted(cj)],
                                       [cj[f] for f in sorted(cj)],
                                       rtol=0, atol=1e-7)
    np.testing.assert_allclose(res_t.z, res_j.z, rtol=0, atol=1e-7)


def test_streaming_cache_hit_gives_the_same_bits_and_a_trace(stream_runs):
    base, runs = stream_runs
    (out_t, res_t), (out_h, res_h) = runs["torch"], runs["torch-hit"]
    np.testing.assert_array_equal(res_h.z, res_t.z)
    np.testing.assert_array_equal(res_h.u, res_t.u)
    # the hit skipped prepare: no prepared rows were written
    assert os.path.isdir(os.path.join(out_t, "tmp-data"))
    assert not os.path.exists(os.path.join(out_h, "tmp-data"))
    for name in ("manifest.json", "vocab.json", "group-0.npz",
                 "group-1.npz"):
        assert os.path.exists(base / "torch-cache" / name), name
    # the JAX package's cache of the same job holds the same manifest
    with open(base / "torch-cache" / "manifest.json") as f:
        mt = json.load(f)
    with open(base / "jax-cache" / "manifest.json") as f:
        assert json.load(f) == mt
    traces = os.listdir(base / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(base / "trace" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_pipeline_use_mesh_matches_jax(tmp_path):
    """use.mesh=true, mesh.devices=2 on 2 gloo ranks against the JAX
    pipeline on 2 virtual devices (tests/test_pipeline.py::
    test_pipeline_use_mesh_config's job: 160 records, 4 blocks): z to
    1e-8 * max|z| with the same trips, the same final models; rank 0 alone
    wrote the outputs (one final-model, checkpoints), every rank returned
    the same z."""
    from mlease_tpu.io import avro as javro, schemas
    rng = np.random.default_rng(4)
    recs = []
    for _ in range(160):
        feats = [{"name": f"f{int(j)}", "term": "", "value": 1.0}
                 for j in rng.choice(6, 2, replace=False)]
        recs.append({"key": "", "response": int(rng.integers(0, 2)),
                     "features": feats, "weight": 1.0, "offset": 0.0})
    data = str(tmp_path / "m.avro")
    javro.write_records(data, schemas.REGRESSION_PREPARE_OUTPUT, recs)

    def props(out):
        return {"input.paths": data, "output.base.path": str(tmp_path / out),
                "num.blocks": "4", "lambda": "1", "num.iters": "4",
                "regularizer": "2", "force.output.overwrite": "true",
                "use.mesh": "true", "mesh.devices": "2", "dtype": "float64",
                "test.path": data, "test.loglik.per.iter": "true"}
    want = jax_pipeline(JobConfig(props("j")))
    per_rank = launch([("p", "pipeline", dict(props=props("t")))], 2,
                      tmp_path / "ranks", timeout=150)["p"]
    np.testing.assert_array_equal(per_rank[1]["z"], per_rank[0]["z"])
    got = per_rank[0]
    np.testing.assert_allclose(got["z"], want.z, rtol=0,
                               atol=1e-8 * float(np.abs(want.z).max()))
    assert got["solver_stats"] == [{k: int(v) for k, v in s.items()}
                                   for s in want.solver_stats]
    assert got["best_lambda"] == want.best_lambda
    _same_models(str(tmp_path / "t"), str(tmp_path / "j"), "final-model",
                 1e-8)
    assert os.listdir(tmp_path / "t" / "checkpoint")
