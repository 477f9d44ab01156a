"""tools/torch_scale_jobs.py --dtype on the CPU: a scale job's copy in
another compute dtype differs from the job's own copy in its output path
and the added `dtype` key alone, and is not held to the JAX package's
float32 run (its other checks stand)."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_scale_jobs", os.path.join(REPO, "tools",
                                              "torch_scale_jobs.py"))


def keys(path):
    with open(path) as f:
        return dict(kv for kv in map(tool._key_value, f.read().splitlines())
                    if kv)


@pytest.mark.parametrize("name", tool.JOBS)
def test_a_dtype_copy_moves_its_output_and_sets_dtype(tmp_path, name):
    own = keys(tool.write_job(name, str(tmp_path)))
    path = tool.write_job(name, str(tmp_path), "bfloat16")
    assert os.path.basename(path) == f"{name}.bfloat16.job"
    copy = keys(path)
    assert copy.pop("dtype") == "bfloat16" and "dtype" not in own
    assert copy.pop("output.base.path") == \
        own.pop("output.base.path") + "-bfloat16"
    assert copy == own


def test_a_dtype_copy_is_not_held_to_the_jax_float32_run():
    jax = tool.JAX_RUNS["ctr-25m"]
    row = {"rc": 0, "python_fallback": False, "native_ingest": True,
           "cache_hit": False, "rows": 2 * tool.PART_ROWS,
           "packed": "packed 16 blocks", "dtype": "bfloat16",
           "summary": {"kernel_launches": {"segment_sum_sorted": 7}},
           "test_loglik": {k: v - 0.01 for k, v in
                           jax["test_loglik"].items()}}
    assert tool.failures("ctr-25m", 1, row, None, None) == []
    # the float32 job on the same row is held to it
    bad = tool.failures("ctr-25m", 1, dict(row, dtype="float32"), None,
                        None)
    assert any("packed" in b for b in bad)
    assert any("loglik" in b for b in bad)
    # a dtype copy's own checks stand
    assert tool.failures("ctr-25m", 1, dict(row, rc=1), None, None)
