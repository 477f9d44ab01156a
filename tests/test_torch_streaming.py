"""The port's streaming trainer (mlease_tpu_torch/train/streaming.py) against
the JAX package's, float64 on the CPU, on the flat multi-RHS group solve
(flat_blocks=True, multi_rhs=True, Jacobi PCG) and on the per-block,
head-block and lanes solves, data from tests/test_admm.py::synth_rows
packed by the JAX package.

Tolerances: z, u and diff_history to atol 1e-8 after 6 iterations, sample
logliks to 1e-9, with equal Newton/CG trip counts per group and iteration
(each group solve agrees to ~1e-14: tests/test_torch_tron_multi.py). Within
the port, the consensus placements, residency tiers, wire formats and tail
paddings move the same bytes through the same operations, so they are held
to the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JTrainer
from mlease_tpu.utils import checkpoint as jckpt
from mlease_tpu_torch.convert import state_from_checkpoint
from mlease_tpu_torch.train.admm import AdmmConfig
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)

def problem(seed=0, n_rows=400, split=(2, 2)):
    """Groups of 2 + 2 blocks (by default) packed independently, so their
    padded shapes and tail widths differ, and held-out rows."""
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    test_rows = synth_rows(rng, 100)
    vocab = build_vocab(rows)
    nb = sum(split)
    blocks = [rows[i::nb] for i in range(nb)]
    groups, lo = [], 0
    for k in split:
        groups.append(pack_blocks(blocks[lo:lo + k], vocab))
        lo += k
    return groups, vocab, test_rows


def configs(head_dtype=None, **kw):
    base = dict(lambdas=[1.0, 10.0], num_iters=6, multi_rhs=True,
                flat_blocks=True, pcg=True)
    base.update(kw)
    hj = {None: None, "bfloat16": jnp.bfloat16}[head_dtype]
    ht = {None: None, "bfloat16": torch.bfloat16}[head_dtype]
    return (JConfig(dtype=jnp.float64, head_dtype=hj, **base),
            AdmmConfig(dtype=torch.float64, head_dtype=ht, **base))


def port(groups, vocab, cfg, **kw):
    return StreamingAdmmTrainer(groups, vocab, cfg, device="cpu", **kw)


def assert_matches_jax(got, want, trips_t, trips_j):
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert [list(d) for d in got.diff_history] == \
        [list(d) for d in want.diff_history]
    np.testing.assert_allclose(
        [list(d.values()) for d in got.diff_history],
        [list(d.values()) for d in want.diff_history], rtol=0, atol=1e-8)
    assert len(trips_t) == len(trips_j)
    for a, b in zip(trips_t, trips_j):
        np.testing.assert_array_equal(a, b)


def assert_same_bits(a, b):
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.u, b.u)
    assert a.diff_history == b.diff_history


@pytest.mark.parametrize("head_size,head_dtype", [
    (0, None), (4, None), (4, "bfloat16")])
def test_matches_jax_with_sample_loglik_and_best_model(head_size,
                                                       head_dtype):
    groups, vocab, test_rows = problem()
    jcfg, tcfg = configs(head_dtype, head_size=head_size,
                         test_loglik_per_iter=True)
    tj = JTrainer(groups, vocab, jcfg, test_rows=test_rows)
    want = tj.run()
    tt = port(groups, vocab, tcfg, test_rows=test_rows)
    got = tt.run()
    assert_matches_jax(got, want, tt.trip_log, tj.trip_log)
    assert len(got.sample_loglik_history) == \
        len(want.sample_loglik_history) > 0
    for a, b in zip(got.sample_loglik_history, want.sample_loglik_history):
        assert (a["lambda"], a["iter"]) == (b["lambda"], b["iter"])
        assert abs(a["testLoglik"] - b["testLoglik"]) <= 1e-9
    assert got.best_lambda == want.best_lambda
    assert abs(got.best_loglik - want.best_loglik) <= 1e-9
    for name, v in want.best_model.coefficients.items():
        assert abs(got.best_model.coefficients[name] - v) <= 1e-8
    assert [s["newton_trips"] for s in got.solver_stats] == \
        [int(t[:, 0].sum()) for t in tj.trip_log]


@pytest.mark.parametrize("kw", [dict(regularizer=1, lambdas=[3.0]),
                                dict(relaxation=1.6, head_size=4)],
                         ids=["l1", "relaxation"])
def test_l1_and_relaxation_match_jax(kw):
    groups, vocab, _t = problem(seed=1, n_rows=300, split=(1, 2))
    jcfg, tcfg = configs(**kw)
    tj = JTrainer(groups, vocab, jcfg)
    tt = port(groups, vocab, tcfg)
    assert_matches_jax(tt.run(), tj.run(), tt.trip_log, tj.trip_log)


def test_warm_start_and_resume_match_an_uninterrupted_run(tmp_path):
    groups, vocab, test_rows = problem(seed=4, n_rows=300)
    jcfg, tcfg = configs(head_size=4, test_loglik_per_iter=True,
                         initialize_boost_rate=3.0)
    z0 = np.random.default_rng(4).normal(size=vocab.size) * 0.1
    full_j = JTrainer(groups, vocab, jcfg, test_rows=test_rows).run(z0=z0)
    full_t = port(groups, vocab, tcfg, test_rows=test_rows).run(z0=z0)
    np.testing.assert_allclose(full_t.z, full_j.z, rtol=0, atol=1e-8)

    # a JAX run stopped after 3 iterations, its checkpoint resumed here
    ck = str(tmp_path / "ck-jax")

    def save_jax(iteration, z, u, diffs, inner_eps, logliks=None):
        jckpt.save_checkpoint(ck, iteration, np.asarray(z), np.asarray(u),
                              inner_eps=inner_eps,
                              mindiff=float(np.min(diffs)),
                              best_loglik=-9999999.0)

    jcfg3 = JConfig(**{**jcfg.__dict__, "num_iters": 3})
    JTrainer(groups, vocab, jcfg3, test_rows=test_rows).run(
        z0=z0, callback=save_jax)
    state = state_from_checkpoint(ck)
    assert state["start_iteration"] == 4
    resumed = port(groups, vocab, tcfg, test_rows=test_rows).run(**state)
    assert resumed.iterations == 6
    np.testing.assert_allclose(resumed.z, full_j.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(resumed.u, full_j.u, rtol=0, atol=1e-8)

    # the port's own checkpoint resumes to the same bits
    ck_t = str(tmp_path / "ck-torch")

    def save_torch(iteration, z, u, diffs, inner_eps, logliks=None):
        jckpt.save_checkpoint(ck_t, iteration, z.numpy(), u.numpy(),
                              inner_eps=inner_eps,
                              mindiff=float(np.min(diffs)),
                              best_loglik=-9999999.0)

    tcfg3 = AdmmConfig(**{**tcfg.__dict__, "num_iters": 3})
    port(groups, vocab, tcfg3, test_rows=test_rows).run(
        z0=z0, callback=save_torch)
    again = port(groups, vocab, tcfg, test_rows=test_rows).run(
        **state_from_checkpoint(ck_t))
    np.testing.assert_array_equal(again.z, full_t.z)
    np.testing.assert_array_equal(again.u, full_t.u)


def test_host_and_device_consensus_give_the_same_bits():
    groups, vocab, test_rows = problem(seed=11)
    _j, tcfg = configs(head_size=4, test_loglik_per_iter=True)
    t_dev = port(groups, vocab, tcfg, test_rows=test_rows,
                 consensus_device=True)
    t_host = port(groups, vocab, tcfg, test_rows=test_rows,
                  consensus_device=False)
    assert t_dev.residency_report()["consensus_device"]
    assert not t_host.residency_report()["consensus_device"]
    r_dev, r_host = t_dev.run(), t_host.run()
    assert_same_bits(r_dev, r_host)
    assert r_dev.sample_loglik_history == r_host.sample_loglik_history


def test_every_residency_tier_and_wire_gives_the_same_bits_and_bytes():
    """Tiers forced by budget; the port's residency report, wire bytes and
    dense-wire bytes equal the JAX trainer's for the same budget."""
    groups, vocab, _t = problem(seed=7, n_rows=480, split=(2, 1, 2))
    jcfg, tcfg = configs(head_size=4, num_iters=4)
    probe = port(groups, vocab, tcfg, resident_head=False)
    g0 = probe.groups[0]
    head0 = g0.head.nbytes + g0.head_ids.nbytes
    heads = sum(g.head.nbytes + g.head_ids.nbytes for g in probe.groups)
    ctail0 = sum(getattr(g0, f).nbytes
                 for f in ("tail_c_rows", "tail_c_cols", "tail_c_vals"))
    settings = {
        "streamed": dict(resident_head=False),
        "one head": dict(resident_head_budget_gb=(head0 + 1) / 2**30),
        "heads": dict(resident_head_budget_gb=(heads + 1) / 2**30),
        "heads + sorted tail": dict(
            resident_head_budget_gb=(heads + ctail0 + 1) / 2**30),
        "all": dict(resident_head=True),
        "streamed, dense wire": dict(resident_head=False,
                                     compact_wire=False),
        "one head, dense wire": dict(
            resident_head_budget_gb=(head0 + 1) / 2**30, compact_wire=False),
    }
    ref = None
    reports = set()
    for name, kw in settings.items():
        tt = port(groups, vocab, tcfg, **kw)
        tj = JTrainer(groups, vocab, jcfg, **kw)
        rep = tt.residency_report()
        assert rep == tj.residency_report(), name
        # the port ships head_ids stacked: (B-1)*H more ids a streamed head
        extra = sum(g.head_ids.nbytes - jg.head_ids.nbytes
                    for gi, (g, jg) in enumerate(zip(tt.groups, tj.groups))
                    if gi not in tt._resident_heads)
        assert tt.stream_wire_bytes() == tj.stream_wire_bytes() + extra, \
            name
        assert tt._dense_wire_bytes() == tj._dense_wire_bytes() + extra, \
            name
        reports.add(tuple(sorted(rep.items())))
        res = tt.run()
        if ref is None:
            ref = res
        else:
            assert_same_bits(res, ref)
    assert len(reports) == len(settings)
    full = port(groups, vocab, tcfg, resident_head=True)
    assert full.stream_wire_bytes() == 0
    assert full._put_group(1)[0] is full._resident_groups[1][0]


def test_padded_and_unpadded_tails_give_the_same_bits():
    """Uneven blocks: tail widths 128 and 768; padded to 768 (forced: auto
    would not pad +38% of the tail bytes) or not."""
    rows = synth_rows(np.random.default_rng(8), 500)
    vocab = build_vocab(rows)
    groups = [pack_blocks([rows[:40]], vocab),
              pack_blocks([rows[40:270], rows[270:500]], vocab)]
    _j, tcfg = configs(head_size=4, num_iters=4)
    padded = port(groups, vocab, tcfg, pad_tails=True)
    plain = port(groups, vocab, tcfg, pad_tails=False)
    auto = port(groups, vocab, tcfg)
    assert padded._tail_orig_T == {0: 128}
    assert not plain._tail_orig_T and not auto._tail_orig_T
    assert_same_bits(padded.run(), plain.run())


def test_next_copy_goes_out_before_the_solve():
    groups, vocab, _t = problem(seed=6, n_rows=300, split=(1, 1, 1))
    _j, tcfg = configs(head_size=4, num_iters=1)
    tr = port(groups, vocab, tcfg, resident_head=False)
    events = []
    orig_put, orig_solver = tr._put_group, tr._solve_group

    def put(gi, u_host=None):
        events.append(("put", gi))
        return orig_put(gi, u_host)

    def solver(*args):
        events.append(("solve", sum(e[0] == "solve" for e in events)))
        return orig_solver(*args)

    tr._put_group, tr._solve_group = put, solver
    tr.run()
    assert events == [("put", 0), ("put", 1), ("solve", 0), ("put", 2),
                      ("solve", 1), ("solve", 2)]


def test_callback_u_deltas_reconstruct_x():
    groups, vocab, _t = problem(seed=12, n_rows=300, split=(2, 1))
    for dev_mode in (True, False):
        _j, tcfg = configs(num_iters=3, lambdas=[2.0])
        seen = []

        def cb(iteration, z, u, diffs, inner_eps, logliks=None):
            seen.append((iteration, z.numpy().copy(), u.numpy().copy()))

        res = port(groups, vocab, tcfg, consensus_device=dev_mode).run(
            callback=cb)
        assert [s[0] for s in seen] == [1, 2, 3]
        assert seen[-1][2].shape == res.u.shape == (1, 3, vocab.size)
        np.testing.assert_array_equal(seen[-1][1], res.z)
        np.testing.assert_array_equal(seen[-1][2], res.u)
        # u_new = u_old + x - z gives x back, and z is the L2 shrinkage
        # N*rho/(lambda + N*rho) of mean(x + u_old), the intercept kept
        _it, z2, u2 = seen[1]
        _it, z3, u3 = seen[2]
        v = (u3 - u2 + z3[:, None, :] + u2).mean(axis=1)
        want = v * 3.0 / (2.0 + 3.0)
        icpt = vocab.intercept_index
        want[:, icpt] = v[:, icpt]
        np.testing.assert_allclose(z3, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw,item", [
    (dict(multi_rhs=False), "A1"), (dict(flat_blocks=False), "A1"),
    (dict(pcg="head_block"), "A1"),
    (dict(pcg="head_block", head_dtype="bfloat16"), "A1")])
def test_unported_solver_modes_raise(kw, item):
    """The group solves of ROADMAP.md item A1, which once raised here, now
    run as the JAX streaming trainer runs them (the same flags on both
    sides): z, u and diffs to 1e-8 with equal trip counts per group and
    iteration. Groups of 1 and 2 blocks (a one-block group's head_block
    solve takes the unbatched head), head 4, the bfloat16 head widened for
    the float64 solve as the JAX package promotes it."""
    groups, vocab, _t = problem(seed=2, n_rows=240, split=(1, 2))
    jcfg, tcfg = configs(head_size=4, num_iters=4, **kw)
    tj = JTrainer(groups, vocab, jcfg)
    tt = port(groups, vocab, tcfg)
    assert tt.mode == ("lanes" if "multi_rhs" in kw else "per_block"), item
    assert_matches_jax(tt.run(), tj.run(), tt.trip_log, tj.trip_log)


def test_mesh_dual_layout_and_dtype_raise(tmp_path):
    """Under a mesh the compact wire is refused (compact_wire=True raises,
    as the JAX package's does; "auto" stays dense: the JAX test
    test_compact_wire_requires_single_device, here on a one-rank mesh);
    the dual layout raises. A bfloat16 compute dtype (A15, once refused
    here) runs against the JAX trainer in bfloat16 under
    tests/test_torch_bf16.py's rule: z within 2 * max(e_j, 2^-8 *
    max|z_j64|) of JAX's bfloat16 and float64 z, e_j JAX's own bfloat16
    error."""
    import torch.distributed as dist

    from mlease_tpu_torch.parallel import distributed, make_mesh
    groups, vocab, _t = problem(seed=2, n_rows=120, split=(1, 1))
    _j, tcfg = configs(head_size=4)
    distributed.initialize("cpu", init_method=f"file://{tmp_path}/pg",
                           world_size=1, rank=0)
    try:
        mesh = make_mesh(1, "cpu")
        with pytest.raises(ValueError, match="single device"):
            port(groups, vocab, tcfg, mesh=mesh, compact_wire=True)
        t = port(groups, vocab, tcfg, mesh=mesh, compact_wire="auto",
                 resident_head=False)
        assert not t._wire and t.mode == "per_block"
        assert port(groups, vocab, tcfg, compact_wire="auto",
                    resident_head=False)._wire
    finally:
        dist.destroy_process_group()
    _j, tcfg = configs(dual_layout=True)
    with pytest.raises(NotImplementedError, match="dual layout"):
        port(groups, vocab, tcfg)
    jcfg, tcfg = configs(num_iters=4)
    want64 = JTrainer(groups, vocab, jcfg).run()
    jcfg.dtype, tcfg.dtype = jnp.bfloat16, torch.bfloat16
    wantbf = JTrainer(groups, vocab, jcfg).run()
    got = port(groups, vocab, tcfg).run()
    assert got.iterations == wantbf.iterations == 4
    bound = 2 * max(np.abs(np.asarray(wantbf.z, np.float64)
                           - want64.z).max(),
                    2.0 ** -8 * np.abs(want64.z).max())
    assert np.abs(got.z - np.asarray(wantbf.z, np.float64)).max() <= bound
    assert np.abs(got.z - want64.z).max() <= bound


MESH_CASES = {
    # name: (config extra, trainer keywords)
    "lanes": (dict(multi_rhs=False, num_iters=4), {}),
    "jacobi_head": (dict(flat_blocks=False, head_size=4, num_iters=4), {}),
    "jacobi_head_host": (dict(flat_blocks=False, head_size=4, num_iters=4),
                         dict(consensus_device=False)),
    "flat_key": (dict(flat_blocks=True, num_iters=4,
                      test_loglik_per_iter=True), {}),
}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    rng = np.random.default_rng(5)
    rows = synth_rows(rng, 300)
    test_rows = synth_rows(rng, 60)
    blocks = [rows[i::3] for i in range(3)]
    cases = []
    for name, (extra, kw) in MESH_CASES.items():
        _j, _t = configs(**extra)
        cfg = dict(lambdas=[1.0, 10.0], num_iters=6, multi_rhs=True,
                   flat_blocks=True, pcg=True, dtype="float64")
        cfg.update(extra)
        cases.append((name, "streaming", dict(
            blocks=blocks, split=(2, 1), mesh=3, config=cfg, kw=kw,
            test_rows=test_rows)))
    return launch(cases, 3, tmp_path_factory.mktemp("stream-mesh"),
                  timeout=150), blocks, test_rows


@pytest.mark.parametrize("name", ["lanes", "jacobi_head", "flat_key"])
def test_streaming_mesh_matches_jax_mesh(mesh_runs, name):
    """Groups of 2 + 1 blocks over 3 ranks (each group padded to 3, each
    rank streaming its one block of each) against the JAX trainer on a
    3-device mesh (tests/test_streaming.py::test_streaming_mesh_parity):
    z, u and diffs to 1e-8, the same trips per group and iteration, every
    rank the same result; flat_blocks=True runs per block on a mesh."""
    import jax

    from mlease_tpu.parallel import make_mesh as jax_make_mesh
    runs, blocks, test_rows = mesh_runs
    per_rank = runs[name]
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r["z"], per_rank[0]["z"])
        np.testing.assert_array_equal(r["u"], per_rank[0]["u"])
        assert r["solver_stats"] == per_rank[0]["solver_stats"]
    got = per_rank[0]
    extra, _kw = MESH_CASES[name]
    jcfg, _t = configs(**extra)
    vocab = build_vocab([r for b in blocks for r in b])
    groups = [pack_blocks(blocks[:2], vocab), pack_blocks(blocks[2:], vocab)]
    tj = JTrainer(groups, vocab, jcfg, test_rows=test_rows,
                  mesh=jax_make_mesh(jax.devices("cpu"), n=3))
    want = tj.run()
    assert got["mode"] == ("lanes" if name == "lanes" else "per_block")
    assert not got["residency"]["compact_wire_groups"]

    class R:                       # the fields assert_matches_jax reads
        pass
    res = R()
    for k in ("z", "u", "iterations", "diff_history"):
        setattr(res, k, got[k])
    assert got["u"].shape == want.u.shape == (2, 3, vocab.size)
    assert_matches_jax(res, want, got["trip_log"], tj.trip_log)
    for a, b in zip(got["sample_loglik_history"],
                    want.sample_loglik_history):
        assert abs(a["testLoglik"] - b["testLoglik"]) <= 1e-9


def test_streaming_mesh_host_and_device_consensus_same_bits(mesh_runs):
    """Both consensus placements take the same all_reduced sums and the
    same elementwise dual update under a mesh too."""
    runs, _b, _t = mesh_runs
    dev, host = runs["jacobi_head"][0], runs["jacobi_head_host"][0]
    assert not host["residency"]["consensus_device"]
    assert dev["residency"]["consensus_device"]
    np.testing.assert_array_equal(host["z"], dev["z"])
    np.testing.assert_array_equal(host["u"], dev["u"])
    for a, b in zip(host["trip_log"], dev["trip_log"]):
        np.testing.assert_array_equal(a, b)
