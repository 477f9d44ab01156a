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

import numpy as np
import pytest
import torch

from mlease_tpu.core.linear_model import read_model_file
from mlease_tpu.io import avro
from mlease_tpu.train.pipeline import run_regression_pipeline as jax_pipeline
from mlease_tpu.utils.config import JobConfig
from mlease_tpu_torch.train.pipeline import \
    run_regression_pipeline as torch_pipeline

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
                                          "gram_batched": 0}
    assert os.path.exists(tmp_path / "out" / "final-model" /
                          "part-r-00000.avro")


def test_unported_job_keys_raise(tmp_path):
    """Paths not ported raise, naming their ROADMAP.md item; streaming
    jobs too for the solver modes the streaming trainer does not run."""
    for extra, item in (
            ({"use.mesh": "true"}, "A8"), ({"mesh.feature.shards": "2"}, "A8"),
            ({"initialize.boost.rate": "2.0"}, "A4"),
            ({"fused.loop": "true"}, "A1"), ({"pcg": "head_block"}, "A1"),
            ({"streaming.groups": "2", "pcg": "head_block"}, "A1"),
            ({"streaming.groups": "2", "flat.blocks": "false"}, "A1"),
            ({"streaming.groups": "2", "multi.rhs": "false"}, "A1")):
        props = job(str(tmp_path / "out"), **extra)
        with pytest.raises(NotImplementedError, match=item):
            torch_pipeline(JobConfig(props), device="cpu")


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
