"""The int32 bound of stacked ids (ROADMAP.md A16): where the port leaves
the flat solve, against the JAX package's gates, and its per-block solve in
sub-stacks past the bound, against the JAX per-block solve, float64 on the
CPU.

The real bound (B*n or B*R at 2^31) needs tens of GB; the tests lower the
port's one constant (ops/tron_multi.py::STACK_ID_BOUND) so that 4 blocks
split into sub-stacks of 2 (or of 1), and hold the port, which then leaves
the flat solve, against JAX with flat_blocks=False (the path JAX takes past
its own bound). stack_blocks raises past the lowered bound, so a run that
passes never stacked ids past it. Every trainer is held so: in memory
(per-block Jacobi, head-block, lanes, run_fused), streaming, naive and
feature-sharded. Tolerances: z and u to 1e-8 with equal per-iteration
trips (each per-block solve agrees to ~1e-12,
tests/test_torch_tron_multi.py); run_fused against run() bit for bit; naive
models to 1e-8 * max|w|.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.admm import AdmmTrainer as JTrainer
from mlease_tpu.train.naive import NaiveConfig as JNaiveConfig
from mlease_tpu.train.naive import train_naive as jax_train_naive
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JStreaming
from mlease_tpu_torch.core import build_vocab as torch_build_vocab
from mlease_tpu_torch.ops import tron_multi
from mlease_tpu_torch.ops.tron_multi import (SubStacks, stack_blocks,
                                             stack_fits, substack_ranges)
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer, solver_mode
from mlease_tpu_torch.train.naive import NaiveConfig, train_naive
from mlease_tpu_torch.train.streaming import (StreamingAdmmTrainer,
                                              _column_order,
                                              groups_fit)

from test_admm import synth_rows

torch.set_num_threads(1)

# (B, n, R): just below the bound, at it by columns, at it by rows
POINTS = [(64, 2**25 - 1, 10), (64, 2**25, 10), (4, 10, 2**29)]


@pytest.mark.parametrize("B,n,R", POINTS, ids=["below", "cols", "rows"])
def test_gates_match_jax_use_flat(B, n, R):
    """The in-memory, streaming and naive gates take the flat solve exactly
    where JAX's AdmmTrainer._use_flat does (the streaming and naive gates
    are its terms over the groups and the keys), and never under a mesh."""
    def jax_flat(**kw):
        ns = SimpleNamespace(config=JConfig(**kw), mesh=None, dim=n,
                             data=SimpleNamespace(nblocks=B, padded_rows=R))
        return JTrainer._use_flat(ns)
    want = jax_flat()
    assert want == (B * n < 2**31 and B * R < 2**31)
    fits = stack_fits(B, n, R)
    assert (solver_mode(True, True, False, True, fits=fits) == "flat") \
        == want
    group = SimpleNamespace(nblocks=B, dim=n, padded_rows=R)
    small = SimpleNamespace(nblocks=1, dim=n, padded_rows=R)
    assert groups_fit([small, group]) == want
    assert (solver_mode(True, True, False, True, fits=groups_fit(
        [group])) == "flat") == want
    assert solver_mode(True, True, False, True, mesh=object(),
                       fits=fits) == "per_block"
    assert not jax_flat(flat_blocks=False)
    assert solver_mode(True, False, False, True, fits=fits) == "per_block"
    assert solver_mode(False, True, False, True, fits=fits) == "lanes"
    # the naive gate's int32 term: stack_fits of (keys, n, R), decided
    # before any stacking
    assert fits == want
    if not want:
        assert len(substack_ranges(B, n, R)) > 1


def test_stack_blocks_refuses_past_the_bound(monkeypatch):
    """stack_blocks raises at the bound; substack_ranges cuts B blocks into
    consecutive ranges that each fit."""
    monkeypatch.setattr(tron_multi, "STACK_ID_BOUND", 41)
    assert substack_ranges(5, 10, 8) == [(0, 4), (4, 5)]
    assert substack_ranges(4, 20, 8) == [(0, 2), (2, 4)]
    with pytest.raises(ValueError, match="past int32"):
        substack_ranges(3, 41, 1)
    B, R, n, L = 5, 8, 10, 1
    args = (torch.zeros((B, R, 2), dtype=torch.int32), torch.zeros((B, R, 2)),
            torch.ones((B, R)), torch.ones((B, R)), torch.zeros((B, R)),
            (None,) * 8, torch.zeros((L, B, n)), torch.ones(L))
    with pytest.raises(ValueError, match="int32"):
        stack_blocks(*args)
    sub = tron_multi.stack_substacks(*args)
    assert isinstance(sub, SubStacks) and sub.ranges == ((0, 4), (4, 5))
    assert [p.y.shape[0] for p in sub.probs] == [4 * R, R]


def problem(seed=31, nblocks=4, n_rows=240):
    rng = np.random.default_rng(seed)
    rows, test_rows = synth_rows(rng, n_rows), synth_rows(rng, 60)
    vocab = build_vocab(rows)
    blocks = [rows[i::nblocks] for i in range(nblocks)]
    return blocks, vocab, pack_blocks(blocks, vocab), test_rows


def lower_bound(monkeypatch, per, *shapes):
    """Lower the bound so that `per` blocks of the widest (n, R) fit."""
    monkeypatch.setattr(tron_multi, "STACK_ID_BOUND",
                        per * max(max(s) for s in shapes) + 1)


MODES = {"per_block-jacobi": dict(pcg=True),
         "per_block-jacobi-1": dict(pcg=True),
         "head_block": dict(pcg="head_block", head_size=4),
         "head_block-1": dict(pcg="head_block", head_size=4),
         "lanes": dict(multi_rhs=False, head_size=4)}


@pytest.mark.parametrize("name", list(MODES))
def test_in_memory_substacks_match_jax_per_block(monkeypatch, name):
    """Past the lowered bound the default (flat) config solves per block,
    in sub-stacks of 2 (of 1 for the "-1" cases): run() and run_fused
    against JAX's run() and run_fused with flat_blocks=False, z and u to
    1e-8 with equal trips; run_fused against run() bit for bit."""
    _b, vocab, data, test_rows = problem()
    lower_bound(monkeypatch, 1 if name.endswith("-1") else 2,
                (vocab.size, data.padded_rows))
    kw = MODES[name]
    base = dict(lambdas=[1.0, 10.0], num_iters=4, test_loglik_per_iter=True)
    tcfg = AdmmConfig(dtype=torch.float64, **base, **kw)
    jcfg = JConfig(dtype=jnp.float64, flat_blocks=False, **base, **kw)

    def port():
        return AdmmTrainer(data, vocab, tcfg, test_rows=test_rows,
                           device="cpu")
    tr = port()
    if "multi_rhs" in kw:
        assert tr.mode == "lanes"
    else:
        assert tr.mode == "per_block" and isinstance(tr.prob, SubStacks)
        assert len(tr.prob.ranges) == (4 if name.endswith("-1") else 2)
    got, fused = tr.run(), port().run_fused()
    jt = JTrainer(data, vocab, jcfg, test_rows=test_rows)
    want, want_fused = jt.run(), JTrainer(data, vocab, jcfg,
                                          test_rows=test_rows).run_fused()
    for g, w in ((got, want), (fused, want_fused)):
        assert g.iterations == w.iterations == 4
        np.testing.assert_allclose(g.z, w.z, rtol=0, atol=1e-8)
        np.testing.assert_allclose(g.u, w.u, rtol=0, atol=1e-8)
        assert g.solver_stats == [{k: int(v) for k, v in s.items()}
                                  for s in w.solver_stats]
    np.testing.assert_array_equal(fused.z, got.z)
    np.testing.assert_array_equal(fused.u, got.u)
    assert fused.diff_history == got.diff_history
    assert fused.sample_loglik_history == got.sample_loglik_history


@pytest.mark.parametrize("kw", [dict(pcg=True),
                                dict(pcg="head_block", head_size=4),
                                dict(multi_rhs=False, head_size=4),
                                dict(multi_rhs=False, column_order=True)],
                         ids=["jacobi", "head_block", "lanes",
                              "lanes-column-order"])
def test_streaming_substacks_match_jax_per_block(monkeypatch, kw):
    """The streaming trainer, groups of 1 and 3 blocks, the bound lowered
    to 2 blocks: the 3-block group ships ids offset per sub-stack and
    solves as sub-stacks of 2 and 1; against the JAX streaming trainer
    with flat_blocks=False, z and u to 1e-8 with equal trips per group and
    iteration. "lanes-column-order": the ELL lanes solve given the column
    order that a lanes solve on the card ships with each group
    (streaming._column_order, made here as the card's trainer makes it),
    so X'd sums over the column-sorted copy each sub-stack unstacks."""
    kw = dict(kw)
    column_order = kw.pop("column_order", False)
    blocks, vocab, _d, test_rows = problem(seed=2)
    groups = [pack_blocks(blocks[:1], vocab), pack_blocks(blocks[1:], vocab)]
    lower_bound(monkeypatch, 2, *[(g.dim, g.padded_rows) for g in groups])
    base = dict(lambdas=[1.0, 10.0], num_iters=4, **kw)
    tt = StreamingAdmmTrainer(groups, vocab,
                              AdmmConfig(dtype=torch.float64, **base),
                              device="cpu")
    assert tt.mode == ("lanes" if "multi_rhs" in kw else "per_block")
    assert tt.ranges == [[(0, 1)], [(0, 2), (2, 3)]]
    if tt.mode == "lanes":
        assert tt.csc_perms == [None, None]    # made on the card only
    else:
        # a multi-RHS group's ELL slots ship their column order on every
        # device (none without ELL slots: the head layout's)
        for perm, g, r in zip(tt.csc_perms, tt.groups, tt.ranges):
            if g.indices.shape[2] == 0:
                assert perm is None
            else:
                assert torch.equal(perm, _column_order(g.indices.numpy(), r))
    if column_order:
        tt.csc_perms = [_column_order(g.indices.numpy(), r)
                        for g, r in zip(tt.groups, tt.ranges)]
        seen = []
        solver = tt._solve_group

        def spy(*a):
            seen.append(a[7] is not None and a[7].numel() == sum(
                p.indices.numel() for p, _ in
                tron_multi.substacks_of(a[1], a[4].shape[1])))
            return solver(*a)
        tt._solve_group = spy
    tj = JStreaming(groups, vocab, JConfig(dtype=jnp.float64,
                                           flat_blocks=False, **base))
    got, want = tt.run(), tj.run()
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert len(tt.trip_log) == len(tj.trip_log)
    for a, b in zip(tt.trip_log, tj.trip_log):
        np.testing.assert_array_equal(a, b)
    if column_order:
        assert seen and all(seen)


@pytest.mark.parametrize("per", [1, 2])
def test_naive_substacks_match_jax_per_key(monkeypatch, per):
    """The naive trainer over 4 keys, the bound lowered to `per` keys: the
    default (flat) config solves one problem per key in sub-stacks, models
    to 1e-8 * max|w| of JAX's per-key solve (flat_blocks=False)."""
    rng = np.random.default_rng(12)
    keyed = {str(i): synth_rows(rng, 50 + 10 * i) for i in range(4)}
    rows = [r for k in sorted(keyed) for r in keyed[k]]
    tv = torch_build_vocab(rows)
    R = max(len(v) for v in keyed.values())
    lower_bound(monkeypatch, per, (tv.size, R))
    base = dict(lambdas=[1.0, 4.0])
    want = jax_train_naive(keyed, JNaiveConfig(dtype=jnp.float64,
                                               flat_blocks=False, **base),
                           vocab=build_vocab(rows))
    got = train_naive(keyed, NaiveConfig(dtype=torch.float64, **base),
                      vocab=tv, device="cpu")
    assert sorted(got.models) == sorted(want.models)
    scale = max(np.abs(m.to_dense(build_vocab(rows))).max()
                for m in want.models.values())
    for k, wm in want.models.items():
        np.testing.assert_allclose(got.models[k].to_dense(tv),
                                   wm.to_dense(build_vocab(rows)), rtol=0,
                                   atol=1e-8 * scale)


def test_feature_sharded_substacks_match_jax(monkeypatch, tmp_path):
    """The feature-sharded trainer on a 1 x 1 mesh (one in-process gloo
    rank), its 4 blocks in sub-stacks past the lowered bound, against the
    JAX feature-sharded trainer on a 1 x 1 mesh: z and u to 1e-8 with
    equal trips."""
    import torch.distributed as dist
    from mlease_tpu.parallel import cpu_devices
    from mlease_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from mlease_tpu.train.feature_sharded import \
        FeatureShardedAdmmTrainer as JFS
    from mlease_tpu_torch.parallel import distributed
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    _b, vocab, data, _t = problem(seed=7)
    lower_bound(monkeypatch, 2, (vocab.size, data.padded_rows))
    base = dict(lambdas=[1.0, 10.0], num_iters=4, flat_blocks=False)
    distributed.initialize("cpu", init_method=f"file://{tmp_path}/pg",
                           world_size=1, rank=0)
    try:
        tr = FeatureShardedAdmmTrainer(
            data, vocab, AdmmConfig(dtype=torch.float64, **base),
            mesh=make_mesh_2d(1, 1, "cpu"))
        assert isinstance(tr.prob, SubStacks) and len(tr.prob.ranges) > 1
        got = tr.run()
    finally:
        dist.destroy_process_group()
    want = JFS(data, vocab, JConfig(dtype=jnp.float64, **base),
               mesh=jax_mesh_2d(cpu_devices(), block=1, feat=1)).run()
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.u, want.u, rtol=0, atol=1e-8)
    assert got.solver_stats == [{k: int(v) for k, v in s.items()}
                                for s in want.solver_stats]
