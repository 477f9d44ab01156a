"""The port's consensus-ADMM trainer and algebra (mlease_tpu_torch.train.admm,
mlease_tpu_torch.ops.admm_math) against the JAX package's, float64 on the
CPU, with data from tests/test_admm.py::synth_rows.

Tolerances: z to atol 1e-8 and sample logliks to 1e-9 after 5 iterations;
each iteration's solve agrees to ~1e-12 (tests/test_torch_tron_multi.py)
and ADMM carries that difference forward without amplifying it at these
well-conditioned sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.ops import admm_math as jam
from mlease_tpu.train.admm import AdmmConfig as JaxConfig
from mlease_tpu.train.admm import AdmmTrainer as JaxTrainer
from mlease_tpu.train.admm import _lambda_key as jax_lambda_key
from mlease_tpu_torch.convert import state_from_checkpoint, state_from_numpy
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math as tam
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer, _lambda_key
from mlease_tpu_torch.utils import checkpoint as ckpt

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)


def problem(seed=21, n_rows=300, nblocks=3):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    test_rows = synth_rows(rng, 80)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    return data, vocab, test_rows


def configs(**kw):
    base = dict(lambdas=[0.5, 5.0, 50.0], test_loglik_per_iter=True)
    base.update(kw)
    return (JaxConfig(dtype=jnp.float64, **base),
            AdmmConfig(dtype=torch.float64, **base))


@pytest.mark.parametrize("head_size", [0, 4])
def test_run_matches_jax_trainer(head_size):
    data, vocab, test_rows = problem()
    jcfg, tcfg = configs(num_iters=5, head_size=head_size)
    want = JaxTrainer(data, vocab, jcfg, test_rows=test_rows).run()
    got = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                      device="cpu").run()
    assert got.iterations == want.iterations == 5
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert [list(d) for d in got.diff_history] == \
        [list(d) for d in want.diff_history]
    assert len(got.sample_loglik_history) == len(want.sample_loglik_history)
    for g, w in zip(got.sample_loglik_history, want.sample_loglik_history):
        assert (g["lambda"], g["iter"]) == (w["lambda"], w["iter"])
        assert g["testLoglik"] == pytest.approx(w["testLoglik"], abs=1e-9)
    assert got.best_lambda == want.best_lambda
    assert got.solver_stats == [
        {k: int(v) for k, v in s.items()} for s in want.solver_stats]


def test_resume_from_jax_state_continues_the_run():
    """k JAX iterations, state carried across, one port iteration ==
    JAX iteration k+1."""
    data, vocab, _ = problem(seed=22)
    k = 3
    jcfg, _ = configs(num_iters=k, head_size=4)
    seen = {}

    def keep(iteration, z, u, diffs, inner_eps, logliks=None):
        seen.update(iteration=iteration, inner_eps=inner_eps,
                    mindiff=float(np.min(diffs)))

    first = JaxTrainer(data, vocab, jcfg).run(callback=keep)
    jcfg_full, tcfg = configs(num_iters=k + 1, head_size=4)
    full = JaxTrainer(data, vocab, jcfg_full).run()

    state = state_from_numpy(first.z, first.u, iteration=seen["iteration"],
                             inner_eps=seen["inner_eps"],
                             mindiff=seen["mindiff"])
    got = AdmmTrainer(data, vocab, tcfg, device="cpu").run(**state)
    assert got.iterations == k + 1 and len(got.diff_history) == 1
    np.testing.assert_allclose(got.z, full.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, full.u, rtol=0, atol=1e-8)
    for key, d in got.diff_history[0].items():
        assert d == pytest.approx(full.diff_history[-1][key], abs=1e-8)


def test_state_from_checkpoint(tmp_path):
    z = np.arange(6.0).reshape(2, 3)
    u = np.ones((2, 4, 3))
    ckpt.save_checkpoint(str(tmp_path), 7, z, u, inner_eps=1e-3,
                         mindiff=0.25, best_loglik=-0.5)
    state = state_from_checkpoint(str(tmp_path))
    assert state["start_iteration"] == 8
    assert state["inner_eps0"] == 1e-3 and state["mindiff0"] == 0.25
    assert state["best_loglik0"] == -0.5
    np.testing.assert_array_equal(state["z0"], z)
    np.testing.assert_array_equal(state["u0"], u)
    assert state_from_checkpoint(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="expected"):
        state_from_numpy(z, u[:, :, :2])


def test_admm_math_matches_expectations_and_jax():
    # the expectations of tests/test_admm.py
    assert tam.default_rho(100) == 1.0 and tam.default_rho(101) == 10.0
    assert tam.rho_effective(2.0, 1, initialize_boost_rate=1.5) == 3.0
    assert tam.rho_effective(2.0, 3, rho_adapt_coefficient=0.3) == \
        pytest.approx(2.0 * np.exp(-2 * 0.3))
    assert tam.inner_eps_schedule(0.01, 2, 1e-4) == pytest.approx(0.001)
    assert tam.inner_eps_schedule(0.01, 6, 0.5, aggressive=True) == \
        pytest.approx(0.001)
    assert tam.inner_eps_schedule(0.01, 5, 1e-9, aggressive=True) == 0.01
    assert tam.should_stop(1e-5, 1e-5) and not tam.should_stop(1e-5, 1e-3)

    v = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    lam = torch.full((3,), 3.0, dtype=torch.float64)
    np.testing.assert_allclose(
        tam.z_update_l2(v, lam, 1.5, 2, intercept_index=2).numpy(),
        [0.5, 1.0, 4.0])
    np.testing.assert_allclose(
        tam.z_update_l2(v, lam, 1.5, 2, 2, penalize_intercept=True).numpy(),
        [0.5, 1.0, 2.0])
    v1 = torch.tensor([0.05, 0.5, -0.5, -0.05, 1.0], dtype=torch.float64)
    lam1 = torch.full((5,), 2.0, dtype=torch.float64)
    np.testing.assert_allclose(
        tam.z_update_l1(v1, lam1, 1.0, 20, intercept_index=4).numpy(),
        [0.0, 0.4, -0.4, 0.0, 1.0], atol=1e-12)
    np.testing.assert_allclose(
        tam.z_update_l1(v1, lam1, 1.0, 20, 4, reference_compat=True).numpy(),
        [0.05, 0.4, -0.4, -0.05, 1.0], atol=1e-12)

    # lane-batched updates (rho (L, 1)) equal the JAX per-lane ones
    rng = np.random.default_rng(8)
    V = rng.normal(size=(3, 7))
    LAM = rng.random(size=(3, 7)) * 4
    rho = np.array([0.5, 1.0, 10.0])
    for reg in (1, 2):
        got = (tam.z_update_l2 if reg == 2 else tam.z_update_l1)(
            torch.as_tensor(V), torch.as_tensor(LAM),
            torch.as_tensor(rho)[:, None], 4, 6)
        for li in range(3):
            want = (jam.z_update_l2 if reg == 2 else jam.z_update_l1)(
                jnp.asarray(V[li]), jnp.asarray(LAM[li]), rho[li], 4, 6)
            np.testing.assert_allclose(got[li].numpy(), np.asarray(want),
                                       rtol=1e-15)
    np.testing.assert_allclose(
        tam.max_abs_diff(torch.as_tensor(V), torch.as_tensor(LAM),
                         axis=-1).numpy(),
        np.asarray(jam.max_abs_diff(jnp.asarray(V), jnp.asarray(LAM),
                                    axis=-1)))


def test_lambda_key_is_byte_identical():
    grid = [0.0, -0.0, 1.0, 0.5, 0.1, 1e-4, 1e-3, 0.00123, 10.0, 100.0,
            1234567.0, 1e7, 1.2345678e7, 3e-9, -2.5, float("inf"),
            float("-inf"), float("nan"), 1 / 3, 2 ** -20, 9999999.0]
    grid += list(np.logspace(-6, 9, 61))
    for lam in grid:
        assert _lambda_key(lam) == jax_lambda_key(lam), lam


MODES = [dict(flat_blocks=False), dict(flat_blocks=False, head_size=4),
         dict(multi_rhs=False), dict(multi_rhs=False, head_size=4),
         dict(dual_layout=True), dict(pcg="head_block", head_size=4),
         dict(dtype=torch.bfloat16)]


@pytest.mark.parametrize("kw", MODES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_unported_paths_raise(kw):
    """The solver modes that once raised here now run as the JAX trainer
    runs them, the same flags on both sides: z and u to 1e-8 with equal
    per-iteration trip counts (the per-block maxima for flat_blocks=False
    and head_block, the per-lane maxima of accepted Newton and CG
    iterations for multi_rhs=False and dual_layout). A bfloat16 compute
    dtype (A15, once refused here) runs the default flat solve against the
    JAX trainer in bfloat16 under tests/test_torch_bf16.py's rule: z within
    2 * max(e_j, 2^-8 * max|z_j64|) of JAX's bfloat16 and float64 z, e_j
    JAX's own bfloat16 error. run_fused of the lanes solve (A1b, once
    refused here) runs against JAX's run_fused, z and u to 1e-8 with equal
    trip totals, and gives the port's run() bit for bit
    (tests/test_torch_fused.py holds every mode it runs)."""
    data, vocab, test_rows = problem(seed=23, n_rows=240)
    if "dtype" in kw:
        base = dict(lambdas=[1.0], num_iters=4)
        want64, wantbf = (JaxTrainer(data, vocab, JaxConfig(dtype=dt,
                                                            **base)).run()
                          for dt in (jnp.float64, jnp.bfloat16))
        trainer = AdmmTrainer(data, vocab, AdmmConfig(**base, **kw),
                              device="cpu")
        assert trainer.mode == "flat"
        got = trainer.run()
        assert got.iterations == wantbf.iterations == 4
        bound = 2 * max(np.abs(np.asarray(wantbf.z, np.float64)
                               - want64.z).max(),
                        2.0 ** -8 * np.abs(want64.z).max())
        assert np.abs(got.z - np.asarray(wantbf.z, np.float64)).max() <= bound
        assert np.abs(got.z - want64.z).max() <= bound
        # run_fused of the lanes solve (A1b, once refused here): JAX's
        # run_fused to 1e-8 with equal trips, run()'s bits
        jcfg, tcfg = configs(num_iters=4, multi_rhs=False)
        want = JaxTrainer(data, vocab, jcfg).run_fused()
        got = AdmmTrainer(data, vocab, tcfg, device="cpu").run_fused()
        run = AdmmTrainer(data, vocab, tcfg, device="cpu").run()
        assert got.iterations == want.iterations == run.iterations == 4
        np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
        np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
        assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                    for s in want.solver_stats]
        np.testing.assert_array_equal(got.z, run.z)
        np.testing.assert_array_equal(got.u, run.u)
        return
    jcfg, tcfg = configs(num_iters=4, **kw)
    want = JaxTrainer(data, vocab, jcfg, test_rows=test_rows).run()
    trainer = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                          device="cpu")
    assert trainer.mode == ("lanes" if "dual_layout" in kw
                            or "multi_rhs" in kw else "per_block")
    got = trainer.run()
    assert got.iterations == want.iterations == 4
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert got.solver_stats == [
        {k: int(v) for k, v in s.items()} for s in want.solver_stats]
    assert got.best_lambda == want.best_lambda


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    data, vocab, _ = problem(seed=24, n_rows=40)
    with pytest.raises(RuntimeError, match="cuda"):
        AdmmTrainer(data, vocab, AdmmConfig())
    assert resolve_device("cpu").type == "cpu"


def test_mesh_resume_takes_each_ranks_slice(tmp_path):
    """Under a mesh the run's callback gets the gathered (L, B, n) u (what
    rank 0 checkpoints) and a resume hands every rank the global u0, of
    which each takes its own blocks: 2 of 3 ranks over 5 blocks (padded
    to 6), stopped after iteration 2 and resumed by new trainers for 2
    more, equal the uninterrupted 4 iterations bit for bit, and the JAX
    trainer on a 3-device mesh to 1e-8."""
    from mlease_tpu.parallel import cpu_devices, make_mesh
    rng = np.random.default_rng(25)
    rows = synth_rows(rng, 250)
    kw = dict(lambdas=[0.5, 5.0], num_iters=4, flat_blocks=False,
              head_size=4)
    cases = [(name, "admm", dict(rows=rows, nblocks=5, mesh=3,
                                 config=dict(kw, dtype="float64"), **extra))
             for name, extra in (("whole", {}), ("resumed",
                                                 {"resume_at": 2}))]
    runs = launch(cases, 3, tmp_path, timeout=120)
    whole, resumed = runs["whole"][0], runs["resumed"][0]
    assert resumed["u0_shape"] == (2, 5, whole["z"].shape[1])
    np.testing.assert_array_equal(resumed["z"], whole["z"])
    np.testing.assert_array_equal(resumed["u"], whole["u"])
    assert resumed["solver_stats"] == whole["solver_stats"][2:]
    for r in runs["resumed"][1:]:
        np.testing.assert_array_equal(r["z"], resumed["z"])
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::5] for i in range(5)], vocab)
    want = JaxTrainer(data, vocab, JaxConfig(dtype=jnp.float64, **kw),
                      mesh=make_mesh(cpu_devices(), n=3)).run()
    atol = 1e-8 * float(np.abs(want.z).max())
    np.testing.assert_allclose(resumed["z"], want.z, rtol=0, atol=atol)
    np.testing.assert_allclose(resumed["u"], want.u, rtol=0, atol=atol)
