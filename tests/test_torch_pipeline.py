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
    for key, value in (("streaming.groups", "2"), ("use.mesh", "true"),
                       ("mesh.feature.shards", "2"),
                       ("initialize.boost.rate", "2.0"),
                       ("pack.cache.dir", str(tmp_path / "cache")),
                       ("fused.loop", "true"), ("pcg", "head_block")):
        props = job(str(tmp_path / "out"), **{key: value})
        with pytest.raises(NotImplementedError):
            torch_pipeline(JobConfig(props), device="cpu")
