"""The port's AdmmTrainer.run_fused (the driver loop on the device; on the
CPU its branches run eagerly) against the JAX package's run_fused, float64
on the CPU, with data from tests/test_admm.py::synth_rows, mirroring
tests/test_admm.py's fused tests.

Tolerances: z and u to 1e-8 with equal iterations and trip totals against
JAX (each iteration's solve agrees to ~1e-12, tests/test_torch_admm.py);
against the port's own run() bit for bit: the same ops on the same values
in the same order. Under a mesh of 2 gloo ranks (tests/torch_mesh_worker.py)
against JAX's run_fused on a 2-device mesh to 1e-8 * max|z|, every rank the
same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.parallel import cpu_devices
from mlease_tpu.parallel import make_mesh as jax_make_mesh
from mlease_tpu.train.admm import AdmmConfig as JaxConfig
from mlease_tpu.train.admm import AdmmTrainer as JaxTrainer
from mlease_tpu_torch.parallel import distributed
from mlease_tpu_torch.parallel.mesh import make_mesh
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)


def problem(seed, n_rows=240, nblocks=3, n_test=60):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    test_rows = synth_rows(rng, n_test) if n_test else None
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    return data, vocab, test_rows, rng


def configs(**kw):
    base = dict(lambdas=[1.0, 10.0], num_iters=4)
    base.update(kw)
    return (JaxConfig(dtype=jnp.float64, **base),
            AdmmConfig(dtype=torch.float64, **base))


def assert_same_run(got, want, atol):
    """got against want: equal iterations, convergence, trips, best lambda;
    z, u, diffs and logliks to atol (0: bit for bit)."""
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    close = (np.testing.assert_array_equal if atol == 0 else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                     atol=atol))
    close(got.z, want.z)
    close(got.u, want.u)
    assert [sorted(d) for d in got.diff_history] == \
        [sorted(d) for d in want.diff_history]
    close([[d[k] for k in sorted(d)] for d in got.diff_history],
          [[d[k] for k in sorted(d)] for d in want.diff_history])
    assert [(e["lambda"], e["iter"]) for e in got.sample_loglik_history] \
        == [(e["lambda"], e["iter"]) for e in want.sample_loglik_history]
    close([e["testLoglik"] for e in got.sample_loglik_history],
          [e["testLoglik"] for e in want.sample_loglik_history])
    assert got.best_lambda == want.best_lambda
    close(got.best_loglik, want.best_loglik)


def totals(stats):
    return {k: sum(int(s[k]) for s in stats)
            for k in ("newton_trips", "cg_trips")}


def test_fused_matches_jax_fused_and_run():
    """The JAX fused test's case (flat Jacobi, a dense head, sample loglik
    per iteration): the port's run_fused against JAX's run_fused, and
    against the port's run() bit for bit."""
    data, vocab, test_rows, _ = problem(11, n_rows=400, nblocks=4,
                                        n_test=150)
    jcfg, tcfg = configs(num_iters=6, test_loglik_per_iter=True,
                         head_size=4)
    want = JaxTrainer(data, vocab, jcfg, test_rows=test_rows).run_fused()
    got = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                      device="cpu").run_fused()
    assert_same_run(got, want, 1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]
    assert len(got.iter_times) == got.iterations
    assert got.compile_time >= 0 and got.wall_time > 0
    run = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                      device="cpu").run()
    assert_same_run(got, run, 0)
    assert got.solver_stats == [totals(run.solver_stats)]
    assert [m.coefficients for m in got.models.values()] == \
        [m.coefficients for m in run.models.values()]
    assert got.best_model.coefficients == run.best_model.coefficients


MODES = {"flat-jacobi": dict(pcg=True), "flat-none": dict(pcg=False),
         "per_block-none": dict(flat_blocks=False, pcg=False),
         "per_block-jacobi": dict(flat_blocks=False, pcg=True),
         "per_block-head_block": dict(pcg="head_block")}


@pytest.mark.parametrize("kw", MODES.values(), ids=MODES.keys())
def test_each_mode_matches_jax(kw):
    """Every mode run_fused covers: trip totals equal to JAX's run_fused,
    z and u to 1e-8, and the port's run() bit for bit."""
    data, vocab, test_rows, _ = problem(31)
    jcfg, tcfg = configs(head_size=4, test_loglik_per_iter=True, **kw)
    want = JaxTrainer(data, vocab, jcfg, test_rows=test_rows).run_fused()
    trainer = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                          device="cpu")
    assert trainer.mode == ("flat" if "flat_blocks" not in kw
                            and kw.get("pcg") != "head_block"
                            else "per_block")
    got = trainer.run_fused()
    assert_same_run(got, want, 1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]
    run = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                      device="cpu").run()
    assert_same_run(got, run, 0)
    assert got.solver_stats == [totals(run.solver_stats)]


def test_warm_start_boost_and_stop():
    """z0 with a boosted first rho and the early stop, on a multi-RHS
    config (JAX's own test uses multi_rhs=False, the lanes solve, which
    test_lanes_and_mesh_raise_a1b runs); epsilon 1e-3 so that the stop
    rule ends the run (at 1e-4 this problem's multi-RHS path runs all
    60)."""
    data, vocab, _, rng = problem(12, n_rows=300, nblocks=2, n_test=0)
    z0 = rng.normal(size=vocab.size) * 0.05
    jcfg, tcfg = configs(lambdas=[5.0], num_iters=60, epsilon=1e-3,
                         initialize_boost_rate=4.0)
    want = JaxTrainer(data, vocab, jcfg).run_fused(z0=z0)
    got = AdmmTrainer(data, vocab, tcfg, device="cpu").run_fused(z0=z0)
    assert got.converged and got.iterations < 60
    assert_same_run(got, want, 1e-8)
    run = AdmmTrainer(data, vocab, tcfg, device="cpu").run(z0=z0)
    assert_same_run(got, run, 0)


def test_chunked_matches_one_chunk():
    """checkpoint_every=2 gives the one-chunk run bit for bit, calls back
    once per chunk (as JAX's run_fused does) and delivers every loglik
    entry once; the callback's state is the chunk end's."""
    data, vocab, test_rows, _ = problem(14, n_rows=300)
    jcfg, tcfg = configs(num_iters=7, test_loglik_per_iter=True)
    one = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                      device="cpu").run_fused()

    def recorder(calls):
        def cb(iteration, z, u, diffs, inner_eps, logliks=None):
            calls.append((iteration, len(logliks or []), float(min(diffs)),
                          inner_eps, np.asarray(z, np.float64)))
        return cb

    calls_t, calls_j = [], []
    chunked = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                          device="cpu").run_fused(
        checkpoint_every=2, callback=recorder(calls_t))
    JaxTrainer(data, vocab, jcfg, test_rows=test_rows).run_fused(
        checkpoint_every=2, callback=recorder(calls_j))
    assert_same_run(chunked, one, 0)
    assert [c[0] for c in calls_t] == [c[0] for c in calls_j] == [2, 4, 6, 7]
    assert [c[1] for c in calls_t] == [c[1] for c in calls_j]
    assert sum(c[1] for c in calls_t) == len(chunked.sample_loglik_history)
    np.testing.assert_allclose([c[2] for c in calls_t],
                               [c[2] for c in calls_j], rtol=0, atol=1e-8)
    assert [c[3] for c in calls_t] == [c[3] for c in calls_j]
    np.testing.assert_array_equal(calls_t[-1][4], chunked.z)


@pytest.mark.parametrize("kw", [
    {"rho_adapt_coefficient": 0.05}, {"initialize_boost_rate": 2.5},
    {"rho_adapt_coefficient": 0.05, "initialize_boost_rate": 2.5}],
    ids=["adapt", "boost", "both"])
def test_rho_schedule(kw):
    """The device's rho table (admm_math.rho_effective on the host, put on
    the device once) gives JAX's fused trajectory and run()'s bits."""
    data, vocab, _, _ = problem(17, n_rows=300, n_test=0)
    z0 = (np.full(vocab.size, 0.1) if kw.get("initialize_boost_rate")
          else None)
    jcfg, tcfg = configs(num_iters=6, **kw)
    want = JaxTrainer(data, vocab, jcfg).run_fused(z0=z0)
    got = AdmmTrainer(data, vocab, tcfg, device="cpu").run_fused(z0=z0)
    assert_same_run(got, want, 1e-8)
    run = AdmmTrainer(data, vocab, tcfg, device="cpu").run(z0=z0)
    assert_same_run(got, run, 0)


@pytest.mark.parametrize("kw", [
    dict(multi_rhs=False), dict(dual_layout=True), dict(mesh=True),
    dict(multi_rhs=False, dtype=torch.bfloat16)],
    ids=["multi_rhs=False", "dual_layout", "mesh", "lanes-bfloat16"])
def test_lanes_and_mesh_raise_a1b(kw):
    """The lanes solve (ops/tron.py's LaneSolver) and a mesh (its
    collectives inside the loop), which once raised here (ROADMAP.md A1b),
    run as JAX's run_fused runs them: multi_rhs=False and dual_layout, and
    a one-rank in-process mesh (the per-block Jacobi solve) against JAX's
    run_fused on a one-device mesh, z and u to 1e-8 with equal iterations
    and trip totals, and against the port's run() bit for bit; the lanes
    solve in bfloat16 (A15) against run() bit for bit."""
    data, vocab, test_rows, _ = problem(19, n_rows=160, nblocks=4)
    dtype = kw.pop("dtype", None)
    mesh = jax_mesh = None
    if kw.pop("mesh", False):
        distributed.initialize_single("cpu")
        mesh = make_mesh(1, "cpu")
        jax_mesh = jax_make_mesh(cpu_devices(), n=1)
    jcfg, tcfg = configs(test_loglik_per_iter=True, head_size=4, **kw)
    if dtype is not None:
        tcfg = AdmmConfig(**dict(tcfg.__dict__, dtype=dtype))
    try:
        def port():
            return AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                               device="cpu", mesh=mesh)
        trainer = port()
        assert trainer.mode == ("per_block" if mesh is not None
                                else "lanes")
        got = trainer.run_fused()
        run = port().run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert_same_run(got, run, 0)
    assert got.solver_stats == [totals(run.solver_stats)]
    if dtype is not None:
        return
    want = JaxTrainer(data, vocab, jcfg, test_rows=test_rows,
                      mesh=jax_mesh).run_fused()
    assert_same_run(got, want, 1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]


MESH_MODES = {"per_block-jacobi": dict(flat_blocks=False, pcg=True),
              "head_block": dict(pcg="head_block", head_size=4),
              "lanes": dict(multi_rhs=False, head_size=4)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every 2-rank case in one launch: each mode's run_fused and run(),
    and per-block Jacobi with checkpoint_every=2."""
    rng = np.random.default_rng(27)
    rows, test_rows = synth_rows(rng, 320), synth_rows(rng, 60)
    base = dict(lambdas=[1.0, 10.0], num_iters=5, test_loglik_per_iter=True,
                dtype="float64")
    cases = [(f"{name}-{how}", "admm", dict(
        rows=rows, nblocks=5, mesh=2, test_rows=test_rows, fused=how,
        config=dict(base, **kw)))
        for name, kw in MESH_MODES.items() for how in ("fused", "run")]
    cases.append(("chunked", "admm", dict(
        rows=rows, nblocks=5, mesh=2, test_rows=test_rows, fused="fused",
        checkpoint_every=2,
        config=dict(base, **MESH_MODES["per_block-jacobi"]))))
    runs = launch(cases, 2, tmp_path_factory.mktemp("fused-mesh"),
                  timeout=150)
    return runs, rows, test_rows, base


@pytest.mark.parametrize("name", list(MESH_MODES))
def test_two_rank_mesh_matches_jax_fused(mesh_runs, name):
    """run_fused on 2 gloo ranks (5 blocks, padded to 6): every rank the
    same z and u, bit for bit the ranks' run(), and JAX's run_fused on a
    2-device mesh to 1e-8 * max|z| with equal iterations and trip totals
    (per-block Jacobi, head-block with a head of 4, the lanes solve)."""
    runs, rows, test_rows, base = mesh_runs
    fused, run = runs[f"{name}-fused"], runs[f"{name}-run"]
    for r in range(2):
        np.testing.assert_array_equal(fused[r]["z"], fused[0]["z"])
        np.testing.assert_array_equal(fused[r]["u"], fused[0]["u"])
        np.testing.assert_array_equal(fused[r]["z"], run[r]["z"])
        np.testing.assert_array_equal(fused[r]["u"], run[r]["u"])
        assert fused[r]["iterations"] == run[r]["iterations"]
        assert fused[r]["diff_history"] == run[r]["diff_history"]
        assert fused[r]["solver_stats"] == [totals(run[r]["solver_stats"])]
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::5] for i in range(5)], vocab)
    cfg = {k: v for k, v in base.items() if k != "dtype"}
    want = JaxTrainer(data, vocab, JaxConfig(dtype=jnp.float64, **cfg,
                                             **MESH_MODES[name]),
                      test_rows=test_rows,
                      mesh=jax_make_mesh(cpu_devices(), n=2)).run_fused()
    got = fused[0]
    assert got["iterations"] == want.iterations
    atol = 1e-8 * float(np.abs(want.z).max())
    np.testing.assert_allclose(got["z"], want.z, rtol=0, atol=atol)
    np.testing.assert_allclose(got["u"], want.u, rtol=0, atol=atol)
    assert got["solver_stats"] == [{k: int(v) for k, v in s.items()}
                                   for s in want.solver_stats]
    assert got["best_lambda"] == want.best_lambda


def test_two_rank_mesh_chunks_match_jax(mesh_runs):
    """checkpoint_every=2 on 2 gloo ranks: the one-chunk run's bits, every
    rank's callback the same, and the callback's chunk ends, loglik entries
    and gathered u as JAX's run_fused on a 2-device mesh gives them (u to
    1e-8 * max|z|)."""
    runs, rows, test_rows, base = mesh_runs
    got, one = runs["chunked"], runs["per_block-jacobi-fused"]
    for r in range(2):
        np.testing.assert_array_equal(got[r]["z"], one[r]["z"])
        np.testing.assert_array_equal(got[r]["u"], one[r]["u"])
        assert got[r]["calls"] == got[0]["calls"]
        for u_r, u_0 in zip(got[r]["chunk_u"], got[0]["chunk_u"]):
            np.testing.assert_array_equal(u_r, u_0)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::5] for i in range(5)], vocab)
    cfg = {k: v for k, v in base.items() if k != "dtype"}
    calls = []

    def cb(iteration, z, u, diffs, inner_eps, logliks=None):
        calls.append((iteration, len(logliks or []), np.asarray(u)))
    JaxTrainer(data, vocab, JaxConfig(dtype=jnp.float64, **cfg,
                                      **MESH_MODES["per_block-jacobi"]),
               test_rows=test_rows,
               mesh=jax_make_mesh(cpu_devices(), n=2)).run_fused(
        checkpoint_every=2, callback=cb)
    assert got[0]["calls"] == [c[:2] for c in calls] \
        == [(2, 4), (4, 4), (5, 2)]
    atol = 1e-8 * float(np.abs(one[0]["z"]).max())
    for u_t, (_i, _n, u_j) in zip(got[0]["chunk_u"], calls):
        # JAX hands its callback the padded (L, 6, n) u, whose padded
        # block is 0; the port the (L, 5, n) u, as run()'s callback
        assert u_t.shape == (2, 5, vocab.size) and u_j.shape[1] == 6
        assert not u_j[:, 5:].any()
        np.testing.assert_allclose(u_t, u_j[:, :5], rtol=0, atol=atol)


@pytest.mark.parametrize("kw", [MODES["flat-jacobi"],
                                MODES["per_block-head_block"]],
                         ids=["flat-jacobi", "per_block-head_block"])
def test_loop_counts_and_nothing_kept(kw):
    """result.loop_counts: one iteration start and end per iteration, one
    CG branch execution per lock-step CG trip (the flat solve's count; a
    per-block solve's trips are each block's, maxed); and once run_fused
    has returned nothing of its loop is left, not even in a reference
    cycle waiting for the garbage collector."""
    import gc
    from mlease_tpu_torch.train.admm import _FusedRun
    data, vocab, test_rows, _ = problem(31)
    _, tcfg = configs(head_size=4, test_loglik_per_iter=True, **kw)
    trainer = AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                          device="cpu")
    gc.collect()
    gc.disable()
    try:
        got = trainer.run_fused(checkpoint_every=2)
        left = [o for o in gc.get_objects() if type(o) is _FusedRun]
    finally:
        gc.enable()
    assert left == []
    runs = got.loop_counts["branch_executions"]
    assert runs["iteration_start"] == runs["iteration_end"] \
        == got.iterations
    trips = got.solver_stats[0]
    if trainer.mode == "flat":
        assert runs["cg_trip"] == trips["cg_trips"]
        assert runs["newton_epilogue"] == trips["newton_trips"]
    else:
        assert runs["cg_trip"] >= trips["cg_trips"]
    assert "kernel_executions" not in got.loop_counts   # counted on a card


@pytest.mark.parametrize("kw", MODES.values(), ids=MODES.keys())
def test_float32_fused_equals_run(kw):
    """In float32, the compute dtype of the card's runs, run_fused gives
    run()'s bits in every covered mode: the head block's factor has the
    same layout in both drivers (the triangular solves' rounding follows
    it), and eps is rounded to float32 in both."""
    data, vocab, test_rows, _ = problem(31)
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=4, head_size=4,
                     test_loglik_per_iter=True, dtype=torch.float32, **kw)
    run = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                      device="cpu").run()
    got = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                      device="cpu").run_fused()
    assert_same_run(got, run, 0)
    assert got.solver_stats == [totals(run.solver_stats)]
