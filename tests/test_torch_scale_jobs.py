"""tools/torch_scale_jobs.py on the CPU: its generator writes the bytes of
examples/make_scale_dataset.py::_write_part (the JAX side runs here only,
on a private build of native/), its job copies differ from
examples/data/ctr-{12m,25m,100m}.job in the four path keys alone, its log
reader reads what the port's `train` CLI logs on the CPU (the
breast-cancer job streamed in 2 groups through a pack cache, twice), and
its checks flag what a run must show."""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

import mlease_tpu.io.fast_decode as jfd
import mlease_tpu.io.fast_encode as jfe
from mlease_tpu.utils.config import JobConfig
from mlease_tpu_torch.io import _native_build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_scale_jobs", os.path.join(REPO, "tools",
                                              "torch_scale_jobs.py"))


@pytest.fixture(scope="module")
def jax_generator(tmp_path_factory):
    """examples/make_scale_dataset.py with mlease_tpu.io.fast_decode bound
    to a private build of native/ (as tests/test_torch_ingest.py binds it:
    the JAX package's own build races between workers)."""
    if _native_build.compiler() is None:
        pytest.skip("no C++ compiler on PATH (g++ or c++)")
    out = tmp_path_factory.mktemp("jax-native") / "libmlease_native.so"
    srcs = [os.path.join(REPO, "native", f)
            for f in ("avro_decode.cpp", "avro_encode.cpp")]
    subprocess.run([_native_build.compiler(), *_native_build.CXXFLAGS, *srcs,
                    "-o", str(out), *_native_build.LDFLAGS], check=True,
                   capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "_LIB_PATH", str(out))
        mp.setattr(jfd, "_lib", None)
        mp.setattr(jfd, "_tried", False)
        assert jfe.is_available()
        yield _load("make_scale_dataset", os.path.join(
            REPO, "examples", "make_scale_dataset.py"))


@pytest.mark.parametrize("seed", [tool.TRAIN_SEED + 3, tool.TEST_SEED],
                         ids=["train-part-3", "test"])
def test_generator_writes_the_jax_generators_bytes(tmp_path, jax_generator,
                                                   seed):
    rows = 20_000
    assert (jax_generator.N_FEATURES, jax_generator.NNZ,
            jax_generator.ZIPF_A, jax_generator.INTERCEPT_TRUE) == (
        tool.N_FEATURES, tool.NNZ, tool.ZIPF_A, tool.INTERCEPT_TRUE)
    assert jax_generator.SCHEMA == tool.SCHEMA
    jax_generator._write_part(str(tmp_path / "jax.avro"), rows, seed)
    tool.write_part(str(tmp_path / "port.avro"), rows, seed)
    assert filecmp.cmp(tmp_path / "jax.avro", tmp_path / "port.avro",
                       shallow=False)
    assert not os.path.exists(tmp_path / "port.avro.partial")


# sha256 of the generator's first 8 chunks of zipf draws (50,000 x 12,
# each followed by the chunk's normal and uniform draws) from a part's
# seed, as numpy 2.0.2 draws them: the JAX runs' dataset
ZIPF_DIGESTS = {
    1000: "f5bfe04342ef34c0497390c941e4c274dac6f7d005df134e8914787ca2419754",
    999: "cda52da484b796ee759b81ec9f6c3384b248ccd69fa35a697efe0373ebe7d5a4"}


@pytest.mark.parametrize("seed", sorted(ZIPF_DIGESTS))
def test_zipf_draws_numpy_2_0s_values(seed):
    """The tool's zipf keeps numpy 2.0's sampler on the stream (later
    numpy draws other values from the same seeds): its draws hash to
    numpy 2.0.2's, and where the installed numpy is 2.0 they equal
    rng.zipf's, the stream left at the same place."""
    import hashlib

    import numpy as np

    mine = np.random.default_rng(seed)
    h = hashlib.sha256()
    old = np.lib.NumpyVersion(np.__version__) < "2.1.0"
    theirs = np.random.default_rng(seed)
    for _ in range(8):
        got = tool.zipf(mine, tool.ZIPF_A, (50_000, tool.NNZ))
        h.update(got.tobytes())
        mine.normal(size=(50_000, tool.NNZ))
        mine.random(50_000)
        if old:
            np.testing.assert_array_equal(
                got, theirs.zipf(tool.ZIPF_A, size=(50_000, tool.NNZ)))
            theirs.normal(size=(50_000, tool.NNZ))
            theirs.random(50_000)
    assert h.hexdigest() == ZIPF_DIGESTS[seed]
    if old:
        assert mine.bit_generator.state == theirs.bit_generator.state


def test_dataset_is_the_jax_runs_dataset():
    """ctr-100m.job's header: SCALE_ROWS=100000000 SCALE_PARTS=8, the
    test file of make_scale_dataset.py (200,000 rows, seed 999), part p
    with seed 1000 + p; the jobs read 1, 2 and 8 parts."""
    with open(os.path.join(REPO, "examples", "data", "ctr-100m.job")) as f:
        assert "SCALE_ROWS=100000000 SCALE_PARTS=8" in f.read()
    assert tool.N_PARTS * tool.PART_ROWS == 100_000_000
    files = tool.dataset_files("/d", tool.N_PARTS)
    assert files[0] == ("/d/test/part-00000.avro", 200_000, 999)
    assert files[1:] == [(f"/d/train/part-{p:05d}.avro", 12_500_000,
                          1000 + p) for p in range(8)]
    for name, parts in tool.PARTS.items():
        paths = tool.example_job(name)["input.paths"]
        read = (8 if paths.endswith("/train")
                else len(paths.split(",")))
        assert read == parts, name
    # ctr-100m's disk: its Avro, its pack cache, two checkpoints
    need = tool.disk_needed("/nonexistent", ["ctr-100m"])
    assert 55e9 < need < 70e9


@pytest.mark.parametrize("name", tool.JOBS)
def test_job_copies_differ_only_in_the_path_keys(tmp_path, name):
    path = tool.write_job(name, str(tmp_path))
    orig = dict(JobConfig.from_file(os.path.join(REPO, "examples", "data",
                                                 f"{name}.job")))
    copy = dict(JobConfig.from_file(path))
    assert set(copy) == set(orig)
    changed = {k for k in orig if copy[k] != orig[k]}
    assert changed == set(tool.PATH_KEYS) & set(orig)
    for k in changed:
        for p in copy[k].split(","):
            assert p.startswith(str(tmp_path) + os.sep), (k, p)
    assert copy["input.paths"].split(",")[0].endswith(
        "train/part-00000.avro" if name != "ctr-100m" else "train")
    assert copy["test.path"] == os.path.join(str(tmp_path), "test")
    # every other line, comments too, as written
    with open(os.path.join(REPO, "examples", "data", f"{name}.job")) as f:
        want = [ln for ln in f.read().splitlines()
                if not ln.split("=")[0].strip() in tool.PATH_KEYS]
    with open(path) as f:
        got = [ln for ln in f.read().splitlines()
               if not ln.split("=")[0].strip() in tool.PATH_KEYS]
    assert got == want


def test_log_reader_reads_a_cpu_run(tmp_path):
    """The port's `train` CLI on the CPU at small size: the breast-cancer
    job in 2 streamed groups (head 16) through a pack cache, twice."""
    data = os.path.join(REPO, "examples", "data", "breast-cancer")
    props = dict(JobConfig.from_file(os.path.join(REPO, "examples", "data",
                                                  "breast-cancer.job")))
    props.update({"input.paths": os.path.join(data, "train"),
                  "test.path": os.path.join(data, "test"),
                  "output.base.path": str(tmp_path / "out"),
                  "head.size": "16", "streaming.groups": "2",
                  "num.iters": "2", "pack.cache.dir": str(tmp_path / "pc")})
    job = tmp_path / "bc.job"
    job.write_text("".join(f"{k}={v}\n" for k, v in props.items()))
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="INFO",
               OMP_NUM_THREADS="1")
    rows = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "mlease_tpu_torch", "train", str(job),
             "--device", "cpu"], capture_output=True, text=True, env=env,
            cwd=str(tmp_path), timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows.append(dict(tool.parse_log(proc.stderr), summary=json.loads(
            proc.stdout.strip().splitlines()[-1])))
    first, second = rows
    assert first["native_ingest"] and not first["python_fallback"]
    assert first["cache_written"] and not first["cache_hit"]
    assert set(first["ingest"]) == {"decode_s", "merge_s", "vocab_s",
                                    "prepare_s", "pack_s"}
    assert first["ingest_rows_per_s"] > 0
    assert first["packed"].startswith("packed 4 blocks, ")
    assert first["rows"] == int(first["native_ingest_line"].split()[0]) > 0
    assert first["features"] > 0 and len(first["padded"]) == 2
    assert set(first["pack_phases"]) == {"hybrid", "cache_write"}
    for row in rows:
        rep = row["residency"]
        assert rep["n_groups"] == 2
        # nothing is page-locked or resident on the CPU
        assert rep["page_locked_bytes"] == 0 == rep["resident_bytes"]
        assert row["wire_gb_per_iter"] >= 0    # %.3f GB: 0.000 here
        assert [it["iter"] for it in row["iters"]] == [1, 2]
        assert all(it["groups"] == 2 and it["newton"] > 0 and it["s"] >= 0
                   for it in row["iters"])
        assert "source" in row["pass_floor"]
        assert set(row["test_loglik"]) == {"0.1", "1.0", "10.0",
                                           "best-model"}
        assert row["test_n"] > 0
        st = row["stage_s"]
        assert st["built"] <= st["first_iter"] <= st["scored"]
    assert second["cache_hit"] and not second["native_ingest"]
    assert "packed" not in second and "cache_loaded" in second["stage_s"]
    assert second["test_loglik"] == first["test_loglik"]
    assert [it["maxdiff"] for it in second["iters"]] == \
        [it["maxdiff"] for it in first["iters"]]


def _row(name, k, **kw):
    jax = tool.JAX_RUNS.get(name)
    row = {"rc": 0, "python_fallback": False, "native_ingest": k == 1,
           "cache_hit": k == 2, "rows": tool.PARTS[name] * tool.PART_ROWS,
           "packed": jax["packed"] if jax else "packed ...",
           "summary": {"kernel_launches": {"segment_sum_sorted": 7}},
           "test_loglik": dict(jax["test_loglik"]) if jax else {}}
    row.update(kw)
    return row


@pytest.mark.parametrize("case,k,kw,flag", [
    ("ok", 1, {}, None),
    ("ok second", 2, {}, None),
    ("exit", 1, {"rc": 137}, "exit code"),
    ("fallback", 1, {"python_fallback": True}, "python"),
    ("no native", 1, {"native_ingest": False}, "native"),
    ("packed", 1, {"packed": "packed 32 blocks, 99 rows"}, "packed"),
    ("no hit", 2, {"cache_hit": False}, "cache"),
    ("rows cut", 1, {"rows": 50_000_000}, "rows"),
    ("no K1", 1, {"summary": {"kernel_launches": {}}}, "K1"),
    ("loglik", 1, {"test_loglik": {"1.0": -0.4763, "10.0": -0.473174,
                                   "100.0": -0.474848}}, "loglik")])
def test_checks_flag_what_a_run_must_show(case, k, kw, flag):
    models = [{"key": "1.0", "model": [1.0]}]
    bad = tool.failures("ctr-100m", k, _row("ctr-100m", k, **kw), models,
                        models)
    if flag is None:
        assert bad == []
    else:
        assert bad and any(flag in b for b in bad), bad
    # the second run's models must equal the first's, bit for bit
    if case == "ok second":
        assert tool.failures("ctr-100m", 2, _row("ctr-100m", 2), models,
                             [{"key": "1.0", "model": [1.0000001]}])
    # ctr-12m has no JAX run: its packed line and logliks are recorded
    assert tool.failures("ctr-12m", 1, _row("ctr-12m", 1), None, None) == []
