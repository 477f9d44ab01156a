"""The naive trainer's solves as device loops (train/naive.py::_solve_keys,
train/admm.py::_SolveLoop with the naive prior fixed) against the
host-driven tron_multi and tron they replaced, and against the JAX
package, on the CPU, where the loop takes the branches the card captures
eagerly: the stacked multi-RHS solve, the per-key solve (in sub-stacks
with the int32 bound lowered) and the lanes solve of multi_rhs=False.

Tolerances: the loop against the host-driven solve bit for bit with equal
trips (the same ops on the same values in the same order); against the JAX
train_naive tests/test_torch_naive.py's 1e-8 * max|w|, in the same branch
on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlease_tpu_torch.train.naive as tnaive
from mlease_tpu.core import build_vocab as jax_build_vocab
from mlease_tpu.train.naive import NaiveConfig as JaxNaiveConfig
from mlease_tpu.train.naive import train_naive as jax_train_naive
from mlease_tpu_torch.core import build_vocab
from mlease_tpu_torch.ops import tron_multi as tm
from mlease_tpu_torch.train.naive import NaiveConfig, train_naive

from test_admm import synth_rows
from test_torch_naive import assert_models_match
from torch_host_solves import host_keys
from torch_mesh_worker import launch

torch.set_num_threads(1)


BRANCHES = {"flat": {}, "per_key": {"flat_blocks": False},
            "substacks": {"flat_blocks": False},
            "lanes": {"multi_rhs": False},
            "flat_no_pcg": {"pcg": False}}


def _dense(res, vocab):
    return np.stack([res.models[k].to_dense(vocab)
                     for k in sorted(res.models)])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_loop_equals_host_and_jax(monkeypatch, branch):
    """Every branch on its loop against the host-driven solve (models bit
    for bit, equal trips), and against
    the JAX package's train_naive; the per-key solve also in 2 sub-stacks
    of 2 and 1 keys (the int32 bound lowered)."""
    rng = np.random.default_rng(0)
    keyed = {str(i): synth_rows(rng, 60 + 30 * i) for i in range(3)}
    rows = [r for k in sorted(keyed) for r in keyed[k]]
    kw = dict(lambdas=[1.0, 4.0], liblinear_epsilon=1e-5,
              lambda_map={"f0": 30.0}, prior_mean=0.02,
              compute_model_mean=True, **BRANCHES[branch])
    vocab = build_vocab(rows)
    cfg = NaiveConfig(dtype=torch.float64, **kw)
    if branch == "substacks":
        data_dim = vocab.size
        rows_per = max(len(v) for v in keyed.values())
        monkeypatch.setattr(tm, "STACK_ID_BOUND",
                            2 * max(data_dim, rows_per) + 1)
    loop = train_naive(keyed, cfg, vocab=vocab, device="cpu")
    seen = []

    def spy(mode, probs, *a):
        seen.append((mode, [r for _p, r in probs]))
        return host_keys(mode, probs, *a)
    with monkeypatch.context() as m:
        m.setattr(tnaive, "_solve_keys", spy)
        host = train_naive(keyed, cfg, vocab=vocab, device="cpu")
    mode = {"flat": "flat", "flat_no_pcg": "flat", "lanes": "lanes"}.get(
        branch, "per_block")
    assert seen == [(mode, [(0, 2), (2, 3)] if branch == "substacks"
                     else [(0, 3)])]
    np.testing.assert_array_equal(_dense(loop, vocab), _dense(host, vocab))
    for k in ("newton_trips", "cg_trips"):
        assert loop.solver_stats[k] == host.solver_stats[k] > 0
    monkeypatch.undo()
    want = jax_train_naive(keyed, JaxNaiveConfig(dtype=jnp.float64, **kw),
                           vocab=jax_build_vocab(rows))
    assert_models_match(loop, want)


def test_bf16_loop_equals_host(monkeypatch):
    """bfloat16, the lanes branch (K1's bf16 entry on the card): the
    host-driven solve's bits and trips."""
    rng = np.random.default_rng(4)
    keyed = {str(i): synth_rows(rng, 80) for i in range(2)}
    cfg = NaiveConfig(dtype=torch.bfloat16, lambdas=[1.0, 4.0],
                      multi_rhs=False)
    vocab = build_vocab([r for k in sorted(keyed) for r in keyed[k]])
    loop = train_naive(keyed, cfg, vocab=vocab, device="cpu")
    monkeypatch.setattr(tnaive, "_solve_keys", host_keys)
    host = train_naive(keyed, cfg, vocab=vocab, device="cpu")
    np.testing.assert_array_equal(_dense(loop, vocab), _dense(host, vocab))
    assert [loop.solver_stats[k] for k in ("newton_trips", "cg_trips")] == \
        [host.solver_stats[k] for k in ("newton_trips", "cg_trips")]


def test_naive_loops_on_two_ranks_match_jax_mesh(tmp_path):
    """3 keys over 2 gloo ranks (padded to 4), the per-key and the lanes
    branch on their loops, against the JAX package on a 2-device mesh:
    models to 1e-8 * max|w|, every rank the same models and trips."""
    import jax

    from mlease_tpu.parallel import make_mesh
    rng = np.random.default_rng(9)
    keyed = {str(i): synth_rows(rng, 50 + 20 * i) for i in range(3)}
    cases = {"per_key": {"flat_blocks": False},
             "lanes": {"multi_rhs": False}}
    base = dict(lambdas=[1.0, 4.0])
    runs = launch([(k, "naive", dict(keyed=keyed, mesh=2, config=dict(
        base, dtype="float64", **kw))) for k, kw in cases.items()], 2,
        tmp_path)
    vocab = jax_build_vocab([r for k in sorted(keyed) for r in keyed[k]])
    for name, kw in cases.items():
        r0, r1 = runs[name]
        assert r0["trips"] == r1["trips"]
        for k, v in r1["models"].items():
            np.testing.assert_array_equal(v, r0["models"][k])
        want = jax_train_naive(keyed, JaxNaiveConfig(dtype=jnp.float64,
                                                     **base, **kw),
                               vocab=vocab,
                               mesh=make_mesh(jax.devices("cpu"), n=2))
        scale = max(np.abs(m.to_dense(vocab)).max()
                    for m in want.models.values())
        for key, m in want.models.items():
            np.testing.assert_allclose(r0["models"][key], m.to_dense(vocab),
                                       rtol=0, atol=1e-8 * scale)
