"""The feature-sharded trainer's x-update as one device loop
(train/feature_sharded.py::FeatureShardedAdmmTrainer._x_update, on
train/admm.py::_SolveLoop with the feat group): on 1 and 2 gloo ranks
(tests/torch_mesh_worker.py, no JAX), where the loop's branches run
eagerly and every rank takes the same phases, against the host-driven
iteration it replaced (`step()`, and run() with the seam `_x_update` set
to `_host_x_update`) and against the JAX package's feature-sharded
trainer on the same grid of the conftest's virtual CPU devices. Rows from
tests/test_admm.py::synth_rows.

Tolerances: the loop against the host-driven path bit for bit with equal
trips (the same ops on the same values in the same order); two run()
calls on one trainer (the loop kept) alike; against JAX in float64 as
tests/test_torch_feature_sharded.py holds the host-driven trainer: z and
u to 1e-8 * max|z|, diffs to 1e-8, equal trips, logliks to 1e-9; in
bfloat16 tests/test_torch_bf16.py's rule with its "mesh" share.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.parallel import cpu_devices
from mlease_tpu.parallel.mesh import make_mesh_2d
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.feature_sharded import FeatureShardedAdmmTrainer as JFS

from test_admm import synth_rows
from test_torch_bf16 import PORT_REL, assert_rule
from torch_mesh_worker import launch

torch.set_num_threads(1)

BASE = dict(lambdas=[1.0, 10.0], num_iters=4, multi_rhs=True, pcg=True,
            flat_blocks=False)

# name -> (world, grid, dtype, config extra, with test rows)
CASES = {
    "grid-1x1": (1, (1, 1), "float64", {}, False),
    "grid-1x2": (2, (1, 2), "float64", {}, True),
    "grid-2x1": (2, (2, 1), "float64", dict(regularizer=1), False),
    "grid-1x2-bf16": (2, (1, 2), "bfloat16", {}, False),
}


def problem(name):
    world, grid, dtype, extra, with_test = CASES[name]
    rows = synth_rows(np.random.default_rng(6), 300)
    test_rows = None
    if with_test:
        rows, test_rows = rows[:240], rows[240:]
    blocks = [rows[i::3] for i in range(3)]
    return world, grid, dtype, blocks, dict(BASE, **extra), test_rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in sorted({c[0] for c in CASES.values()}):
        cases = []
        for name in (n for n, c in CASES.items() if c[0] == world):
            _w, grid, dtype, blocks, cfg, test_rows = problem(name)
            cases.append((name, "fs_loop", dict(
                blocks=blocks, grid=grid, test_rows=test_rows,
                config=dict(cfg, dtype=dtype))))
        out.update(launch(cases, world, tmp_path_factory.mktemp(
            f"fsloop{world}"), timeout=150))
    return out


def same_run(a, b):
    for k in ("z", "u"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("iterations", "solver_stats", "diff_history",
              "sample_loglik_history", "best_lambda", "best_loglik",
              "converged"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("name", list(CASES))
def test_loop_equals_the_host_driven_step(runs, name):
    """run() on the loop, run() again (the loop kept: made once) and run()
    with the seam on the host-driven solve give the same bits and trips on
    every rank; one iteration from random z and u through step() and
    through the loop alike; the ranks of a feat group (one block row,
    rank = b * feat + s) took the same branches."""
    world, grid = CASES[name][:2]
    per_rank = runs[name]
    assert len(per_rank) == world
    for rank, r in enumerate(per_rank):
        assert r["loops_made"] == 1
        same_run(r["loop"], r["host"])
        same_run(r["loop_again"], r["loop"])
        for a, b in zip(r["one_step"]["step"], r["one_step"]["loop"]):
            np.testing.assert_array_equal(a, b)
        first = per_rank[rank - rank % grid[1]]
        assert r["branches"] == first["branches"]
        assert sum(r["branches"].values()) > 0
        same_run(r["loop"], per_rank[0]["loop"])


@pytest.mark.parametrize("name", list(CASES))
def test_loop_matches_jax(runs, name):
    """The loop's run against the JAX feature-sharded trainer on the same
    grid: float64 as tests/test_torch_feature_sharded.py holds it,
    bfloat16 by tests/test_torch_bf16.py's rule."""
    _w, grid, dtype, blocks, cfg, test_rows = problem(name)
    vocab = build_vocab([r for b in blocks for r in b])
    data = pack_blocks(blocks, vocab)
    mesh = make_mesh_2d(cpu_devices(), block=grid[0], feat=grid[1])
    got = runs[name][0]["loop"]

    def jax_run(dt):
        return JFS(data, vocab, JConfig(dtype=dt, **cfg),
                   test_rows=test_rows, mesh=mesh).run()
    want = jax_run(jnp.float64)
    assert got["iterations"] == want.iterations
    if dtype == "bfloat16":
        want_bf = jax_run(jnp.bfloat16)
        assert_rule(got["z"], want_bf.z, want.z, PORT_REL["mesh"])
        assert_rule(got["u"], want_bf.u, want.u, PORT_REL["mesh"])
        return
    atol = 1e-8 * float(np.abs(want.z).max())
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
