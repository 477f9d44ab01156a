"""Each x-update as one device loop (train/admm.py::_SolveLoop): the loop
against the host-driven solve it replaced in AdmmTrainer.run() and in the
streaming trainer's group solves, and both trainers against the JAX
package's, on the CPU, where the loop takes the branches the card captures
eagerly. Data from tests/test_admm.py::synth_rows, packed by the JAX
package.

Tolerances: the loop against build_x_update / build_group_solver on the
same inputs bit for bit with equal trips (the same ops on the same values
in the same order); against the JAX trainers in float64 z and u to 1e-8
with equal trips (each solve agrees to ~1e-12,
tests/test_torch_tron_multi.py); residency tiers, wire formats and slots
move the same bytes through the same loops, so they are held to the same
bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.train.admm import AdmmConfig as JaxConfig
from mlease_tpu.train.admm import AdmmTrainer as JaxTrainer
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JaxStreaming
from mlease_tpu_torch.ops import tron_multi
from mlease_tpu_torch.train.admm import (AdmmConfig, AdmmTrainer,
                                         build_x_update, x_prior)
from mlease_tpu_torch.train.streaming import (StreamingAdmmTrainer,
                                              build_group_solver)

from test_admm import synth_rows

torch.set_num_threads(1)


def blocks(seed, n_rows=300, nblocks=3, n_test=0):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    vocab = build_vocab(rows)
    test_rows = synth_rows(rng, n_test) if n_test else None
    return [rows[i::nblocks] for i in range(nblocks)], vocab, test_rows


def groups_of(parts, vocab, split):
    out, lo = [], 0
    for k in split:
        out.append(pack_blocks(parts[lo:lo + k], vocab))
        lo += k
    return out


SOLVES = {                      # config, solve mode, loop parts
    "flat": (dict(pcg=True), "flat", 1),
    "per_block": (dict(flat_blocks=False), "per_block", 1),
    "head_block": (dict(pcg="head_block"), "per_block", 1),
    "lanes": (dict(multi_rhs=False), "lanes", 1),
    "lanes_dual_layout": (dict(dual_layout=True, head_size=0), "lanes", 1),
    "substacks": (dict(flat_blocks=False, substacks=True), "per_block", 2),
    "bf16": (dict(dtype=torch.bfloat16), "flat", 1),
}


@pytest.mark.parametrize("kw,mode,nparts", SOLVES.values(),
                         ids=SOLVES.keys())
def test_loop_equals_the_host_solve(monkeypatch, kw, mode, nparts):
    """One _SolveLoop against build_x_update's solve on the same inputs,
    twice in a row on the same loop (its state written anew by each
    set_inputs): x bit for bit and equal trips, in every solve mode, in 2
    sub-stacks (the int32 bound lowered: 3 blocks as 2 and 1) and in
    bfloat16."""
    kw = dict(kw)
    parts, vocab, _t = blocks(3)
    data = pack_blocks(parts, vocab)
    if kw.pop("substacks", False):
        monkeypatch.setattr(tron_multi, "STACK_ID_BOUND",
                            2 * max(data.dim, data.padded_rows) + 1)
    cfg = AdmmConfig(**dict(dict(lambdas=[1.0, 10.0], head_size=4,
                                 dtype=torch.float64), **kw))
    tr = AdmmTrainer(data, vocab, cfg, device="cpu")
    assert tr.mode == mode
    L, n, B, dt = 2, tr.dim, data.nblocks, cfg.dtype
    solve = build_x_update(tr.mode, cfg.max_newton_iter, cfg.max_cg_iter,
                           cfg.pcg, cfg.relaxation)
    rng = np.random.default_rng(4)
    loop = None
    for _ in range(2):
        z = torch.as_tensor(rng.normal(size=(L, n)) * 0.1, dtype=dt)
        u = torch.as_tensor(rng.normal(size=(L, B, n)) * 0.1, dtype=dt)
        rho = torch.as_tensor(tr.rhos, dtype=dt)
        eps = cfg.liblinear_epsilon * tr.eps_scale
        x, trips = solve(tr.prob, tr.present, z, u, rho, eps)
        if loop is None:
            loop = tr._solve_loop(z, u, rho, eps)
            loop.own_loop()
            assert [(p.b0, p.b1) for p in loop.parts] == \
                ([(0, 2), (2, 3)] if nparts == 2 else [(0, 3)])
        loop.solve(z, u, rho, eps)
        got = solve.finish(loop.x(), tr.present, x_prior(z, u), z)
        assert torch.equal(got, x)
        np.testing.assert_array_equal(loop.trips().numpy(), trips)


@pytest.mark.parametrize("regularizer", [1, 2], ids=["L1", "L2"])
def test_run_matches_jax(regularizer):
    """AdmmTrainer.run() through its device loop against the JAX trainer's
    run in float64 (flat Jacobi, a dense head, sample loglik per
    iteration): z, u, diffs and logliks to 1e-8, equal trips and best
    lambda."""
    parts, vocab, test_rows = blocks(7, n_rows=360, nblocks=4, n_test=90)
    data = pack_blocks(parts, vocab)
    base = dict(lambdas=[1.0, 10.0], num_iters=5, head_size=4,
                regularizer=regularizer, test_loglik_per_iter=True)
    want = JaxTrainer(data, vocab, JaxConfig(dtype=jnp.float64, **base),
                      test_rows=test_rows).run()
    got = AdmmTrainer(data, vocab, AdmmConfig(dtype=torch.float64, **base),
                      test_rows=test_rows, device="cpu").run()
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        [[d[k] for k in sorted(d)] for d in got.diff_history],
        [[d[k] for k in sorted(d)] for d in want.diff_history],
        rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        [e["testLoglik"] for e in got.sample_loglik_history],
        [e["testLoglik"] for e in want.sample_loglik_history],
        rtol=0, atol=1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]
    assert got.best_lambda == want.best_lambda


def test_two_runs_make_the_loop_once():
    """Two calls of run() on one trainer make (on the card: capture) the
    x-update loop once and give what two fresh trainers give, bit for
    bit: the second run starts from its own z0 and u0, whatever the loop
    held."""
    parts, vocab, _t = blocks(9)
    data = pack_blocks(parts, vocab)
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=4,
                     dtype=torch.float64)
    z0 = np.random.default_rng(1).normal(size=(2, vocab.size)) * 0.05
    tr = AdmmTrainer(data, vocab, cfg, device="cpu")
    first = tr.run()
    loop = tr._loops["x"]
    second = tr.run(z0=z0)
    assert tr._loops["x"] is loop
    for got, want in ((first, AdmmTrainer(data, vocab, cfg,
                                          device="cpu").run()),
                      (second, AdmmTrainer(data, vocab, cfg,
                                           device="cpu").run(z0=z0))):
        np.testing.assert_array_equal(got.z, want.z)
        np.testing.assert_array_equal(got.u, want.u)
        assert got.diff_history == want.diff_history
        assert got.solver_stats == want.solver_stats


STREAMS = {
    "flat 2+1+2": (dict(), {}, (2, 1, 2)),
    "per_block 1+2": (dict(flat_blocks=False), {}, (1, 2)),
    "head_block 2+1+2 host u": (dict(pcg="head_block"),
                                dict(consensus_device=False), (2, 1, 2)),
    "lanes 1+2+2 streamed": (dict(multi_rhs=False),
                             dict(resident_head=False), (1, 2, 2)),
    "flat 1+2+2 streamed host u": (dict(), dict(resident_head=False,
                                                consensus_device=False),
                                   (1, 2, 2)),
}


@pytest.mark.parametrize("ckw,tkw,split", STREAMS.values(),
                         ids=STREAMS.keys())
def test_streaming_matches_jax(ckw, tkw, split):
    """The streaming trainer's group solves through their device loops
    against the JAX streaming trainer, float64: z and u to 1e-8 and equal
    per-group trips each iteration, groups of 1 and 2 blocks, three groups
    (two share a slot from one iteration to the next when they stream),
    device- and host-resident consensus."""
    parts, vocab, _t = blocks(5, n_rows=400, nblocks=sum(split))
    groups = groups_of(parts, vocab, split)
    base = dict(lambdas=[1.0, 10.0], num_iters=4, head_size=4, **ckw)
    tj = JaxStreaming(groups, vocab, JaxConfig(dtype=jnp.float64, **base),
                      **tkw)
    tt = StreamingAdmmTrainer(groups, vocab,
                              AdmmConfig(dtype=torch.float64, **base),
                              device="cpu", **tkw)
    got, want = tt.run(), tj.run()
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert len(tt.trip_log) == len(tj.trip_log)
    for a, b in zip(tt.trip_log, tj.trip_log):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sorted(tt._loops) == list(range(len(split)))


TIERS = {
    "streamed": dict(resident_head=False),
    "streamed, dense wire": dict(resident_head=False, compact_wire=False),
    "heads": "heads",
    "one group": "one group",
    "host u": dict(resident_head=False, consensus_device=False),
}
# the solve of every tier: the flat multi-RHS solve (the ids of the tiers
# as they were), and the lanes solve of multi_rhs=False, whose streamed
# groups are unstacked anew into their loops' tensors after every copy
# (train/streaming.py::_refresh)
SOLVE_TIERS = [pytest.param(tier, ckw, id=f"{prefix}{tid}")
               for prefix, ckw in (("", {}), ("lanes ", dict(multi_rhs=False)))
               for tid, tier in TIERS.items()]


@pytest.mark.parametrize("tier,ckw", SOLVE_TIERS)
def test_slots_give_the_all_resident_bits(tier, ckw):
    """Three groups of 2, 1 and 2 blocks (the first and the last share a
    slot), in every residency tier and wire, in the multi-RHS and the
    lanes solve: the same bits as the run with every group resident,
    whose loops read their own tensors (no slot); each group solve equals
    build_group_solver's on its inputs."""
    parts, vocab, _t = blocks(8, n_rows=400, nblocks=5)
    groups = groups_of(parts, vocab, (2, 1, 2))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=4,
                     dtype=torch.float64, **ckw)

    def port(**kw):
        return StreamingAdmmTrainer(groups, vocab, cfg, device="cpu", **kw)
    probe = port(resident_head=False)
    if tier == "heads":
        tier = dict(resident_head_budget_gb=(sum(
            g.head.nbytes + g.head_ids.nbytes for g in probe.groups) + 1)
            / 2**30)
    elif tier == "one group":
        g0 = probe.groups[0]
        tier = dict(resident_head_budget_gb=(
            g0.head.nbytes + g0.head_ids.nbytes + sum(
                getattr(g0, f).nbytes for f in (
                    "indices", "values", "y", "weight", "offset", "present",
                    "tail_rows", "tail_cols", "tail_vals", "tail_c_rows",
                    "tail_c_cols", "tail_c_vals"))
            + sum(g.head.nbytes + g.head_ids.nbytes
                  for g in probe.groups[1:]) + 1) / 2**30)
    ref = port(resident_head=True)
    assert ref._slot_of == {}
    tt = port(**tier)
    host = build_group_solver(cfg.max_newton_iter, cfg.max_cg_iter,
                              mode=tt.mode, pcg=cfg.pcg)
    solve, seen = tt._solve_group, []

    def check(gi, prob, present, z, u, rho_eff, eps, perm):
        x, trips = solve(gi, prob, present, z, u, rho_eff, eps, perm)
        xh, nt, cg = host(prob, present, z, u, rho_eff, eps, perm)
        seen.append(torch.equal(x, xh) and trips.tolist() == [nt, cg])
        return x, trips
    tt._solve_group = check
    got, want = tt.run(), ref.run()
    assert seen and all(seen)
    shipping = [gi for gi in range(3) if gi not in tt._resident_groups
                or not tt._consensus_device]
    assert tt._slot_of == {gi: k % 2 for k, gi in enumerate(shipping)}
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_array_equal(got.u, want.u)
    assert got.diff_history == want.diff_history
    assert [t.tolist() for t in tt.trip_log] == \
        [t.tolist() for t in ref.trip_log]
    assert tt.mode == ref.mode == ("lanes" if ckw else "flat")
