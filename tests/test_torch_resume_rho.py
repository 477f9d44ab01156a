"""A resumed run and a run whose rho moves, on the trainers' device loops
(train/admm.py::_SolveLoop), on the CPU, where the loops take the
branches the card captures eagerly.

Resume: `run()` of AdmmTrainer and of StreamingAdmmTrainer (its groups
streamed through the two slots, in the multi-RHS and the lanes solve)
stopped after 2 iterations, its state kept by the callback as the train
pipeline's checkpoint keeps it (train/pipeline.py: z, u, inner_eps, the
smallest diff, the best-loglik sentinel; convert.state_from_numpy), then a
new trainer resumed at iteration 3 for 2 more: z, u, diffs and trips bit
for bit with the uninterrupted 4 iterations (the same ops on the same
values: the state crosses the host exactly), in float64 and float32; and
in float64 the JAX trainer's uninterrupted run to 1e-8 with equal trips.

rho adaptation (rho.adapt.coefficient > 0: rho_eff moves every
iteration, and reaches each loop through its inputs): run() on its loop
against run() with the x-update through build_x_update's host-driven
solve, bit for bit with equal trips; and the JAX trainer in float64, z
and u to 1e-8 with equal trips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.train.admm import AdmmConfig as JaxConfig
from mlease_tpu.train.admm import AdmmTrainer as JaxTrainer
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JaxStreaming
from mlease_tpu_torch.convert import state_from_numpy
from mlease_tpu_torch.ops import admm_math
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

from test_admm import synth_rows

torch.set_num_threads(1)

JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def data(seed, n_rows=320, nblocks=4, n_test=80):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    parts = [rows[i::nblocks] for i in range(nblocks)]
    return parts, vocab, synth_rows(rng, n_test)


TRAINERS = {                    # streamed: (2, 2) groups, nothing pinned
    "run": (False, {}),
    "streamed multi_rhs": (True, {}),
    "streamed lanes": (True, dict(multi_rhs=False)),
}


def make(streamed, parts, vocab, test_rows, cfg, jax=False):
    if streamed:
        groups = [pack_blocks(parts[:2], vocab), pack_blocks(parts[2:],
                                                             vocab)]
        if jax:
            return JaxStreaming(groups, vocab, cfg, test_rows=test_rows,
                                resident_head=False)
        return StreamingAdmmTrainer(groups, vocab, cfg, test_rows=test_rows,
                                    resident_head=False, device="cpu")
    packed = pack_blocks(parts, vocab)
    if jax:
        return JaxTrainer(packed, vocab, cfg, test_rows=test_rows)
    return AdmmTrainer(packed, vocab, cfg, test_rows=test_rows, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("streamed,ckw", TRAINERS.values(),
                         ids=TRAINERS.keys())
def test_resume_equals_the_uninterrupted_run(streamed, ckw, dtype):
    parts, vocab, test_rows = data(11)
    base = dict(lambdas=[1.0, 10.0], num_iters=4, head_size=4,
                test_loglik_per_iter=True, **ckw)
    cfg = AdmmConfig(dtype=dtype, **base)
    whole = make(streamed, parts, vocab, test_rows, cfg).run()
    kept = {}

    def checkpoint(iteration, z, u, diffs, inner_eps, logliks=None):
        kept.update(state_from_numpy(
            z.cpu().numpy(), u.cpu().numpy(), iteration=iteration,
            inner_eps=inner_eps, mindiff=float(np.min(diffs)),
            best_loglik=-9999999.0))

    first = make(streamed, parts, vocab, test_rows, AdmmConfig(
        dtype=dtype, **dict(base, num_iters=2))).run(callback=checkpoint)
    assert first.iterations == 2 and kept["start_iteration"] == 3
    tr = make(streamed, parts, vocab, test_rows, cfg)
    resumed = tr.run(**kept)
    assert resumed.iterations == whole.iterations == 4
    np.testing.assert_array_equal(resumed.z, whole.z)
    np.testing.assert_array_equal(resumed.u, whole.u)
    assert first.diff_history + resumed.diff_history == whole.diff_history
    assert first.solver_stats + resumed.solver_stats == whole.solver_stats
    if dtype != torch.float64:
        return
    jt = make(streamed, parts, vocab, test_rows,
              JaxConfig(dtype=jnp.float64, **base), jax=True)
    want = jt.run()
    assert want.iterations == 4
    np.testing.assert_allclose(resumed.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(resumed.u, want.u, rtol=0, atol=1e-8)
    if streamed:
        assert [t.tolist() for t in tr.trip_log] == \
            [np.asarray(t).tolist() for t in jt.trip_log[2:]]
    else:
        assert resumed.solver_stats == [
            {k: int(v) for k, v in s.items()} for s in want.solver_stats[2:]]


RHO_SOLVES = {"flat": {}, "per_block": dict(flat_blocks=False),
              "lanes": dict(multi_rhs=False)}


@pytest.mark.parametrize("ckw", RHO_SOLVES.values(), ids=RHO_SOLVES.keys())
def test_rho_adaptation_loop_equals_host_and_jax(ckw):
    parts, vocab, test_rows = data(12)
    base = dict(lambdas=[1.0, 10.0], num_iters=4, head_size=4,
                rho_adapt_coefficient=0.1, test_loglik_per_iter=True, **ckw)
    cfg = AdmmConfig(dtype=torch.float64, **base)
    rhos = [admm_math.rho_effective(1.0, i, rho_adapt_coefficient=0.1)
            for i in range(1, 5)]
    assert len(set(rhos)) == 4          # rho_eff moves every iteration
    loop = make(False, parts, vocab, test_rows, cfg).run()
    tr = make(False, parts, vocab, test_rows, cfg)
    solve = tr.step.solve

    def host_x_update(z, u, rho_eff, eps):
        x, trips = solve(tr.prob, tr.present, z, u, rho_eff, eps)
        return x, torch.as_tensor(trips)
    tr._x_update = host_x_update
    host = tr.run()
    assert "x" not in tr._loops          # no device loop on the host path
    np.testing.assert_array_equal(loop.z, host.z)
    np.testing.assert_array_equal(loop.u, host.u)
    assert loop.diff_history == host.diff_history
    assert loop.solver_stats == host.solver_stats
    want = make(False, parts, vocab, test_rows,
                JaxConfig(dtype=jnp.float64, **base), jax=True).run()
    assert loop.iterations == want.iterations
    np.testing.assert_allclose(loop.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(loop.u, want.u, rtol=0, atol=1e-8)
    assert loop.solver_stats == [{k: int(v) for k, v in s.items()}
                                 for s in want.solver_stats]
