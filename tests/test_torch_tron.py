"""The port's batched solvers (mlease_tpu_torch.ops.tron, ops.newton)
against the JAX package's, float64 on the CPU.

A batch of problems that converge at different trip counts goes through the
port's masked lock-step solvers in one call and through the JAX solvers one
by one (which is what `jax.vmap` of them computes per lane). Tolerances:
`tron` w to atol 1e-8 with equal per-lane Newton and CG iteration counts
(no trust-region decision flips on these fixtures, so both take the same
steps); `newton_cholesky` w to rtol 1e-5, which its float32 factorisation
bounds (LAPACK's and XLA's float32 Cholesky round differently and the
Newton iteration does not contract that away below ~1e-7), with equal
per-lane iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu.ops.objective as jobj
import mlease_tpu_torch.ops.objective as tobj
from mlease_tpu.ops.newton import newton_cholesky as jnewton
from mlease_tpu.ops.tron import tron as jtron, tron_batched as jtron_batched
from mlease_tpu_torch.ops.newton import newton_cholesky as tnewton
from mlease_tpu_torch.ops.tron import tron as ttron, tron_batched

from test_tron import make_problem

torch.set_num_threads(1)

PRIOR_VARS = (2.0, 0.05, 50.0, 1.0, 400.0)
EPS = np.array([1e-6, 1e-2, 1e-8, 1e-4, 1e-7])


def batch():
    jprobs = [make_problem(seed=s, prior_var=pv)[0]
              for s, pv in enumerate(PRIOR_VARS)]
    tprob = tobj.LRProblem(**{
        k: None if getattr(jprobs[0], k) is None else torch.as_tensor(
            np.stack([np.asarray(getattr(p, k)) for p in jprobs])).to(
                torch.int64 if k == "indices" else torch.float64)
        for k in jobj.LRProblem._fields})
    return jprobs, tprob


def test_tron_matches_jax_lane_by_lane():
    jprobs, tprob = batch()
    n = tprob.dim
    got = ttron(tprob, torch.zeros((len(jprobs), n), dtype=torch.float64),
                torch.as_tensor(EPS))
    iters = []
    for i, p in enumerate(jprobs):
        want = jtron(p, jnp.zeros(n, jnp.float64), EPS[i])
        np.testing.assert_allclose(got.w[i].numpy(), np.asarray(want.w),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(float(got.f[i]), float(want.f), rtol=1e-12)
        assert int(got.iterations[i]) == int(want.iterations)
        assert int(got.cg_iterations[i]) == int(want.cg_iterations)
        assert bool(got.converged[i]) == bool(want.converged)
        iters.append(int(want.iterations))
    assert len(set(iters)) > 1            # lanes do stop at different trips
    assert got.newton_trips >= max(iters)


def test_tron_matches_jax_vmapped_with_warm_start_and_caps():
    """Warm starts, and iteration caps that cut lanes off mid-solve: the
    per-lane counts still equal the vmapped JAX solver's."""
    jprobs, tprob = batch()
    n = tprob.dim
    rng = np.random.default_rng(0)
    W0 = rng.normal(size=(len(jprobs), n)) * 0.2
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jprobs)
    for max_iter, max_cg in ((1000, 500), (3, 2)):
        want = jtron_batched(stacked, jnp.asarray(W0), jnp.asarray(EPS),
                             max_iter=max_iter, max_cg_iter=max_cg)
        got = tron_batched(tprob, torch.as_tensor(W0), torch.as_tensor(EPS),
                           max_iter=max_iter, max_cg_iter=max_cg)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=0, atol=1e-8)
        np.testing.assert_array_equal(got.iterations.numpy(),
                                      np.asarray(want.iterations))
        np.testing.assert_array_equal(got.cg_iterations.numpy(),
                                      np.asarray(want.cg_iterations))
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(want.converged))


def test_tron_converged_start_takes_no_trip():
    jprobs, tprob = batch()
    n = tprob.dim
    cold = ttron(tprob, torch.zeros((len(jprobs), n), dtype=torch.float64),
                 1e-6)
    warm = ttron(tprob, cold.w, 1e-6)
    assert warm.newton_trips == 0 and int(warm.iterations.sum()) == 0
    torch.testing.assert_close(warm.w, cold.w, rtol=0, atol=0)


def test_newton_cholesky_matches_jax_lane_by_lane():
    jprobs, tprob = batch()
    n = tprob.dim
    got = tnewton(tprob, torch.zeros((len(jprobs), n), dtype=torch.float64),
                  torch.as_tensor(EPS))
    iters = []
    for i, p in enumerate(jprobs):
        want = jnewton(p, jnp.zeros(n, jnp.float64), EPS[i])
        np.testing.assert_allclose(got.w[i].numpy(), np.asarray(want.w),
                                   rtol=1e-5, atol=1e-7)
        assert int(got.iterations[i]) == int(want.iterations)
        assert bool(got.converged[i]) == bool(want.converged)
        iters.append(int(want.iterations))
    assert len(set(iters)) > 1
    assert got.trips == max(iters)


def test_newton_cholesky_warm_start_and_iteration_cap():
    jprobs, tprob = batch()
    n = tprob.dim
    zeros = torch.zeros((len(jprobs), n), dtype=torch.float64)
    cold = tnewton(tprob, zeros, 1e-6)
    assert bool(cold.converged.all())
    warm = tnewton(tprob, cold.w, 1e-6)
    assert warm.trips == 0 and int(warm.iterations.sum()) == 0
    capped = tnewton(tprob, zeros, 1e-12, max_iter=2)
    for i, p in enumerate(jprobs):
        want = jnewton(p, jnp.zeros(n, jnp.float64), 1e-12, max_iter=2)
        assert int(capped.iterations[i]) == int(want.iterations) == 2
        np.testing.assert_allclose(capped.w[i].numpy(), np.asarray(want.w),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("solver", ["tron", "newton"])
def test_float32_solve_reaches_the_float64_solution(solver):
    jprobs, tprob = batch()
    n = tprob.dim
    p32 = tobj.LRProblem(*[v if v is None or v.dtype == torch.int64
                           else v.float() for v in tprob])
    fn = ttron if solver == "tron" else tnewton
    lo = fn(p32, torch.zeros((len(jprobs), n)), 1e-4)
    hi = fn(tprob, torch.zeros((len(jprobs), n), dtype=torch.float64), 1e-8)
    assert lo.w.dtype == torch.float32
    np.testing.assert_allclose(lo.w.numpy(), hi.w.numpy(), rtol=0, atol=2e-3)
