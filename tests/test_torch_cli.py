"""The port's `fit` and `naive` subcommands (mlease_tpu_torch/cli.py) against
the JAX package's (mlease_tpu/cli.py), both run in this process on the same
files, float64 on the CPU (`--device cpu`).

fit: the text model, `.var` and `.cov` files carry the same names in the
same order, every value within 1e-10 of the JAX value relative to the
largest magnitude in its file, and the same Newton and CG counts on the
closing line; the parsers (`read_libsvm`, `_parse_fit_option`,
`_read_text_model`) give exactly equal results. naive: the same JSON
summary keys and values, and the same models/ and final-model/ records
(coefficients within 1e-8 of the largest).
"""

import json
import os

import numpy as np
import pytest
import torch

import mlease_tpu.cli as jcli
import mlease_tpu_torch.cli as tcli
from mlease_tpu.core import build_vocab as jax_build_vocab
from mlease_tpu.core.linear_model import read_model_file
from mlease_tpu.io import avro, schemas
from mlease_tpu_torch.core import build_vocab

torch.set_num_threads(1)


def write_libsvm(path, n=150, feats=("a", "b", "c"), seed=9):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=len(feats))
    lines = []
    for _ in range(n):
        x = rng.normal(size=len(feats))
        keep = rng.random(len(feats)) < 0.8
        p = 1 / (1 + np.exp(-(x[keep] @ w[keep] - 0.3)))
        toks = [f"{f}:{v:.4f}" for f, v, k in zip(feats, x, keep) if k]
        lines.append(" ".join([str(int(rng.random() < p)), *toks]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_text(path):
    """[(name, value)] in file order."""
    out = []
    for line in open(path).read().splitlines():
        name, _, value = line.rpartition(" = ")
        out.append((name, float(value)))
    return out


def assert_same_text(got_path, want_path, rtol=1e-10):
    got, want = read_text(got_path), read_text(want_path)
    assert [n for n, _ in got] == [n for n, _ in want]
    scale = max(abs(v) for _, v in want)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=rtol * scale)


def run_fit(tmp_path, capsys, data, *flags, tag=""):
    """`fit` through both CLIs; returns the two --out paths and the two
    closing lines."""
    outs, lines = [], []
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}{tag}.txt")
        assert main(["fit", data, "--out", out, *flags, *extra]) == 0
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
        outs.append(out)
    return outs, lines


@pytest.mark.parametrize("flags", [
    ["--f64", "--posterior-var", "--posterior-cov"],
    ["--f64", "--posterior-var", "--posterior-cov", "--binary-feature"],
    ["--f64", "--option", "max_iter=50, epsilon=1e-6, positive_weight=2",
     "--posterior-var"],
    ["--f64", "--bias", "0", "--prior-var", "0.5", "--epsilon", "1e-4"]],
    ids=["var-cov", "binary", "option", "no-bias"])
def test_fit_matches_jax(tmp_path, capsys, flags):
    data = write_libsvm(str(tmp_path / "t.libsvm"))
    (want, got), (line_j, line_t) = run_fit(tmp_path, capsys, data, *flags)
    assert_same_text(got, want)
    for ext in (".var", ".cov"):
        assert os.path.exists(got + ext) == os.path.exists(want + ext)
        if os.path.exists(want + ext):
            assert_same_text(got + ext, want + ext)
    # "# iterations=I cg=C f=... converged=..."
    assert line_t.split()[:3] == line_j.split()[:3]
    assert line_t.split()[-1] == line_j.split()[-1]


def test_fit_init_and_param_match_jax(tmp_path, capsys):
    """--init warm start (from the first fit: no step taken) and --param,
    a per-feature prior-mean file, through both CLIs."""
    data = write_libsvm(str(tmp_path / "t.libsvm"), seed=3)
    (want, got), _ = run_fit(tmp_path, capsys, data, "--f64", tag="0")
    (want2, got2), (line_j, line_t) = run_fit(
        tmp_path, capsys, data, "--f64", "--init", want, tag="1")
    assert "iterations=0" in line_t and "iterations=0" in line_j
    assert_same_text(got2, want2)
    param = str(tmp_path / "prior.txt")
    with open(param, "w") as f:
        f.write("a = 2.5\nb = -1.0\nunknown = 4\n")
    (want3, got3), (line_j, line_t) = run_fit(
        tmp_path, capsys, data, "--f64", "--param", param, "--prior-var",
        "0.05", "--prior-mean", "0.25", tag="2")
    assert_same_text(got3, want3)
    assert line_t.split()[:3] == line_j.split()[:3]


def test_fit_parsers_match_jax(tmp_path, capsys):
    data = write_libsvm(str(tmp_path / "t.libsvm"), seed=5)
    with open(data, "a") as f:
        f.write("\n1 name:with:colons:2.5 b:-1e-3\n")
    assert tcli.read_libsvm(data) == jcli.read_libsvm(data)
    for bad in ("x a:1\n", "1 :2\n"):
        path = str(tmp_path / "bad.libsvm")
        open(path, "w").write(bad)
        with pytest.raises(ValueError) as ej:
            jcli.read_libsvm(path)
        with pytest.raises(ValueError) as et:
            tcli.read_libsvm(path)
        assert str(et.value) == str(ej.value)
    for opt in ("", "epsilon=0.5", " max_iter = 7 , type=lr,verbose=1,",
                "positive_weight=2,epsilon=1e-6"):
        assert tcli._parse_fit_option(opt) == jcli._parse_fit_option(opt)
    for bad in ("bogus=1", "epsilon", "epsilon=", "max_iter=x"):
        with pytest.raises(ValueError) as ej:
            jcli._parse_fit_option(bad)
        with pytest.raises(ValueError) as et:
            tcli._parse_fit_option(bad)
        assert str(et.value) == str(ej.value)
    rows = tcli.read_libsvm(data)
    model = str(tmp_path / "m.txt")
    with open(model, "w") as f:
        f.write("a = 1.5\n(INTERCEPT) = -0.25\nzz = 3\nb =\nc=7e-3\n")
    for default in (0.0, 0.5):
        np.testing.assert_array_equal(
            tcli._read_text_model(model, build_vocab(rows), default),
            jcli._read_text_model(model, jax_build_vocab(rows), default))
    with pytest.raises(SystemExit):
        tcli.main(["fit", data, "--posterior-cov", "--device", "cpu"])
    with pytest.raises(ValueError):
        tcli.main(["fit", data, "--option", "bogus=1", "--device", "cpu"])


def _naive_avro(tmp_path, n=240, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        nnz = int(rng.integers(1, 5))
        feats = [{"name": f"f{int(j)}", "term": "", "value": float(rng.normal())}
                 for j in rng.choice(10, nnz, replace=False)]
        score = sum(f["value"] for f in feats) - 0.3
        recs.append({"key": f"k{i % 3}",
                     "response": int(rng.random() < 1 / (1 + np.exp(-score))),
                     "features": feats, "weight": 1.0, "offset": 0.0})
    path = str(tmp_path / "naive.avro")
    avro.write_records(path, schemas.REGRESSION_PREPARE_OUTPUT, recs)
    return path


@pytest.mark.parametrize("keying", [{"num.blocks": "3"}, {"map.key": "key"}],
                         ids=["blocks", "map.key"])
def test_naive_cli_matches_jax(tmp_path, capsys, keying):
    data = _naive_avro(tmp_path)
    outs, summaries = {}, {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}-out")
        job = str(tmp_path / f"{name}.job")
        props = {"input.paths": data, "output.base.path": out,
                 "lambda": "1,5", "compute.model.mean": "true",
                 "dtype": "float64", "liblinear.epsilon": "1e-6", **keying}
        with open(job, "w") as f:
            f.writelines(f"{k}={v}\n" for k, v in props.items())
        assert main(["naive", job, *extra]) == 0
        summaries[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        outs[name] = out
    got, want = summaries["torch"], summaries["jax"]
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu"
    assert got["kernel_launches"] == {"segment_sum_sorted": 0,
                                      "gram_batched": 0,
                                      "head_xv": 0, "head_xtv": 0}
    for sub in ("models", "final-model"):
        mj = read_model_file(os.path.join(outs["jax"], sub))
        mt = read_model_file(os.path.join(outs["torch"], sub))
        assert list(mt) == list(mj)
        scale = max(abs(v) for m in mj.values()
                    for v in [m.intercept, *m.coefficients.values()])
        for key, m in mj.items():
            assert list(mt[key].coefficients) == list(m.coefficients)
            assert abs(mt[key].intercept - m.intercept) <= 1e-8 * scale
            np.testing.assert_allclose(
                list(mt[key].coefficients.values()),
                list(m.coefficients.values()), rtol=0, atol=1e-8 * scale)


def test_train_mesh_under_the_launcher_matches_jax(tmp_path, capsys):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    mlease_tpu_torch train --mesh 2 --device cpu job` (the JAX test
    tests/test_cli.py::test_cli_predict_alias_and_mesh_flag's job, 4
    blocks) against `python -m mlease_tpu train --mesh 2` on its virtual
    devices: rank 0 alone prints the summary line, with the JAX line's
    iterations, models and best loglik (1e-9), and writes the same final
    models (1e-8). The launcher takes a free port from the OS
    (--standalone), so concurrent test workers cannot collide; the run has
    a deadline."""
    import subprocess
    import sys

    from test_cli import synth_avro, write_job
    data = synth_avro(tmp_path)
    keys = {"input.paths": data, "test.path": data, "num.blocks": 4,
            "lambda": "1", "num.iters": 3, "regularizer": 2,
            "force.output.overwrite": "true", "dtype": "float64"}
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    job_j = write_job(tmp_path / "j", **keys,
                      **{"output.base.path": str(tmp_path / "out_j")})
    job_t = write_job(tmp_path / "t", **keys,
                      **{"output.base.path": str(tmp_path / "out_t")})
    assert jcli.main(["train", job_j, "--mesh", "2"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mlease_tpu_torch", "train",
         "--mesh", "2", "--device", "cpu", job_t],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        out, err = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail("the 2-rank train --mesh run exceeded its deadline")
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out          # rank 0 alone prints
    got = json.loads(lines[0])
    for k in ("iterations", "converged", "best_lambda", "models"):
        assert got[k] == want[k], k
    assert got["best_loglik"] == pytest.approx(want["best_loglik"],
                                               rel=1e-9)
    assert got["device"] == "cpu"
    mj = read_model_file(str(tmp_path / "out_j" / "final-model"))
    mt = read_model_file(str(tmp_path / "out_t" / "final-model"))
    assert sorted(mj) == sorted(mt)
    for k in mj:
        assert abs(mt[k].intercept - mj[k].intercept) <= 1e-8
        for f, w in mj[k].coefficients.items():
            assert abs(mt[k].coefficients[f] - w) <= 1e-8


def test_train_mesh_outside_a_launcher(tmp_path, capsys, monkeypatch):
    """Outside a launcher `train --mesh 1` starts a one-rank group itself
    and runs; `--mesh 2` raises and names the launcher command."""
    import torch.distributed as dist

    from test_cli import synth_avro, write_job
    data = synth_avro(tmp_path)
    job = write_job(tmp_path, **{
        "input.paths": data, "output.base.path": str(tmp_path / "o"),
        "num.blocks": 2, "lambda": "1", "num.iters": 2, "regularizer": 2,
        "dtype": "float64"})
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError,
                       match="torch.distributed.run --nproc-per-node 2"):
        tcli.main(["train", job, "--mesh", "2", "--device", "cpu"])
    assert not dist.is_initialized()
    try:
        assert tcli.main(["train", job, "--mesh", "1", "--device",
                          "cpu"]) == 0
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["iterations"] == 2 and got["models"] == ["1.0"]
