"""The bfloat16 compute dtype (dtype = bfloat16) through the port's trainers,
entry points and K1's bf16 entry, against the JAX package run in bfloat16
on the CPU, with data from tests/test_admm.py::synth_rows.

Tolerance rule. Each comparison runs the JAX package twice, in float64
(z_j64) and in bfloat16 (z_jbf), and takes JAX's own bfloat16 error
e_j = max|z_jbf - z_j64|. The port's bfloat16 result z_t is held to

    max|z_t - z_jbf| <= 2 * max(e_j, 2^-8 * max|z_j64|)   and
    max|z_t - z_j64| <= the same bound,

sample logliks to the same rule on |loglik|. A second, tighter check
holds the port to its own measured distance from float64: max|z_t - z_j64|
<= 2 * PORT_REL[case] * max|z_j64|, PORT_REL the largest such share the
case gave when it was written (the port sums in float32 and lands far
nearer float64 than JAX's bfloat16 does: 0.2-1.1% of max|z| here, against
1-19% for JAX), so that a regression of a few percent in the port's
bfloat16 path fails even where JAX's own error would allow it. Trip
counts are recorded, not
held equal (bfloat16 trips rise: the inner-eps floor of 1e-5 is below
bfloat16's resolution). Model keys, skipped keys and output file names are
held equal. Bits cannot be: XLA's CPU segment_sum on a bfloat16 stream
accumulates in bfloat16 and XLA keeps some bfloat16 intermediates in
float32 inside its fusions, while the port keeps margins and the
objective in float32 and sums over the data in float32 (K1 too),
rounding a kept vector once (ops/segment_sum.py::accumulate_dtype; the
rule is stated in ops/tron_multi.py's docstring). The rule covers those
differences.

K1's plain versions in bfloat16 are held to a float64 evaluation of the
same sum: per segment one bfloat16 rounding (2^-8 * |sum|) plus
1e-5 * sum|contrib|; untouched segments keep their bits.
"""

import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.cli import main as jmain
from mlease_tpu.core import build_vocab as jbuild_vocab
from mlease_tpu.core import pack_blocks
from mlease_tpu.core.linear_model import read_model_file
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.admm import AdmmTrainer as JTrainer
from mlease_tpu.train.naive import NaiveConfig as JNaiveConfig
from mlease_tpu.train.naive import train_naive as jtrain_naive
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JStreaming
from mlease_tpu.utils.config import JobConfig
from mlease_tpu_torch.cli import main as tmain
from mlease_tpu_torch.convert import state_from_checkpoint
from mlease_tpu_torch.core import build_vocab
from mlease_tpu_torch.ops.segment_sum import (segment_sum_gather,
                                              segment_sum_sorted)
from mlease_tpu_torch.train import NaiveConfig, train_naive
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = os.path.join(REPO, "examples", "data", "breast-cancer.job")
DATA = os.path.join(REPO, "examples", "data", "breast-cancer")


def bound(z_jbf, z_j64) -> float:
    """2 * max(e_j, 2^-8 * max|z_j64|): the rule's bound."""
    z_jbf = np.asarray(z_jbf, np.float64)
    e_j = float(np.abs(z_jbf - z_j64).max())
    return 2.0 * max(e_j, 2.0 ** -8 * float(np.abs(z_j64).max()))


# the port's measured max|z_t - z_j64| / max|z_j64| per case (the largest
# over the case's z, u, logliks or models), rounded up
PORT_REL = {
    "admm/flat": 5.3e-3, "admm/flat-head4": 5.3e-3,
    "admm/per_block": 4.1e-3, "admm/head_block": 3.8e-3,
    "admm/lanes": 4.2e-3, "admm/lanes-head4": 8.3e-3,
    "admm/dual_layout": 4.2e-3, "admm/l1": 7.2e-3,
    "stream/flat-head4": 7.5e-3, "stream/head_block": 7.0e-3,
    "mesh": 7.4e-3, "naive": 2.2e-3, "train_cli": 7.1e-3,
    "streamed_and_fused": 1.1e-2, "naive_item_cli": 4.1e-3,
}


def assert_rule(z_t, z_jbf, z_j64, port_rel):
    z_t = np.asarray(z_t, np.float64)
    z_jbf = np.asarray(z_jbf, np.float64)
    z_j64 = np.asarray(z_j64, np.float64)
    assert z_t.shape == z_jbf.shape == z_j64.shape
    assert np.isfinite(z_t).all()
    b = bound(z_jbf, z_j64)
    assert float(np.abs(z_t - z_jbf).max()) <= b
    assert float(np.abs(z_t - z_j64).max()) <= b
    assert float(np.abs(z_t - z_j64).max()) <= \
        2 * port_rel * float(np.abs(z_j64).max())


def assert_logliks_rule(got, want_bf, want_64, port_rel):
    key = [(e["lambda"], e["iter"]) for e in want_64]
    assert [(e["lambda"], e["iter"]) for e in got] == key
    assert [(e["lambda"], e["iter"]) for e in want_bf] == key
    assert_rule([e["testLoglik"] for e in got],
                [e["testLoglik"] for e in want_bf],
                [e["testLoglik"] for e in want_64], port_rel)


def model_array(models) -> np.ndarray:
    """Models {key: LinearModel} as one array, keys and names sorted."""
    return np.array([v for k in sorted(models) for v in
                     [models[k].intercept]
                     + [models[k].coefficients[n]
                        for n in sorted(models[k].coefficients)]])


def assert_models_rule(got, want_bf, want_64, port_rel):
    assert sorted(got) == sorted(want_bf) == sorted(want_64)
    for key in want_64:
        assert sorted(got[key].coefficients) == \
            sorted(want_64[key].coefficients), key
    assert_rule(model_array(got), model_array(want_bf), model_array(want_64),
                port_rel)


# ---------------------------------------------------------------------------
# K1's plain versions in bfloat16
# ---------------------------------------------------------------------------

def k1_inputs(seed, T, S, m, L):
    """vals (T,), V (L, m), idx, seg (ids below S - 40: the last 40
    segments untouched), out0 (L, S) and contrib (L, T)."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, S - 40, T)).astype(np.int32)
    bf = (lambda a: torch.as_tensor(a, dtype=torch.bfloat16))  # noqa: E731
    return (bf(rng.normal(size=T)), bf(rng.normal(size=(L, m))),
            torch.as_tensor(rng.integers(0, m, T), dtype=torch.int32),
            torch.as_tensor(seg), bf(rng.normal(size=(L, S))),
            bf(rng.normal(size=(L, T))))


@pytest.mark.parametrize("L", [1, 3, 6])
def test_k1_plain_bf16_against_f64(L):
    """The gather form into an accumulator (the last L // 2 lanes squared,
    as the gradient + diagonal pass calls it) and the contrib form into
    zeros: per segment within one bf16 rounding plus 1e-5 * sum|contrib|
    of the float64 sum of the same bf16 inputs; untouched segments keep
    their bits; the result is bfloat16."""
    S = 400
    vals, V, idx, seg, out0, contrib = k1_inputs(L, 3000, S, 90, L)
    sf = L - L // 2
    got = segment_sum_gather(vals, V, idx, seg, S, out=out0.clone(),
                             square_from=sf)
    v64, V64 = vals.double(), V.double()[:, idx.long()]
    w = torch.cat([v64 * V64[:sf], v64 * v64 * V64[sf:]])
    ref = out0.double().index_add(1, seg.long(), w)
    scale = out0.double().abs().index_add(1, seg.long(), w.abs())
    assert got.dtype == torch.bfloat16
    err = (got.double() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-5 * scale).all())
    hit = torch.zeros(S, dtype=torch.bool)
    hit[seg.long()] = True
    assert (~hit).any() and torch.equal(got[:, ~hit], out0[:, ~hit])

    got = segment_sum_sorted(contrib, seg, S)
    ref = torch.zeros((L, S), dtype=torch.float64).index_add(
        1, seg.long(), contrib.double())
    scale = torch.zeros((L, S), dtype=torch.float64).index_add(
        1, seg.long(), contrib.double().abs())
    assert got.dtype == torch.bfloat16
    err = (got.double() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-5 * scale).all())
    assert bool((got[:, ~hit] == 0).all())


@pytest.mark.parametrize("L", [1, 3, 6])
def test_k1_plain_bf16_into_float32(L):
    """The gather form with bfloat16 vals and V into a float32 accumulator
    (how a bfloat16 solve calls it: its scores and X'v sums stay float32):
    no rounding into out, so per segment within 1e-5 * scale of the
    float64 sum of the same inputs; untouched segments keep their bits; a
    bfloat16 accumulator of another shape, or a float64 one, is refused."""
    S = 400
    vals, V, idx, seg, out0, _ = k1_inputs(10 + L, 3000, S, 90, L)
    out0 = out0.float()
    sf = L - L // 2
    got = segment_sum_gather(vals, V, idx, seg, S, out=out0.clone(),
                             square_from=sf)
    v64, V64 = vals.double(), V.double()[:, idx.long()]
    w = torch.cat([v64 * V64[:sf], v64 * v64 * V64[sf:]])
    ref = out0.double().index_add(1, seg.long(), w)
    scale = out0.double().abs().index_add(1, seg.long(), w.abs())
    assert got.dtype == torch.float32
    assert bool(((got.double() - ref).abs() <= 1e-5 * scale).all())
    hit = torch.zeros(S, dtype=torch.bool)
    hit[seg.long()] = True
    assert torch.equal(got[:, ~hit], out0[:, ~hit])
    for bad in (out0.double(), out0[:, 1:].bfloat16()):
        with pytest.raises(ValueError, match="out must be"):
            segment_sum_gather(vals, V, idx, seg, S, out=bad)


def test_k1_plain_bf16_rounds_once():
    """Many small terms into one segment: the float32 sum, rounded once
    into out (1 + 2^-8 alone rounds back to 1 in bfloat16, so a sum that
    rounded at every entry would stay at 1)."""
    vals = torch.full((4096,), 2.0 ** -8, dtype=torch.bfloat16)
    seg = torch.zeros(4096, dtype=torch.int32)
    out = torch.ones((1, 1), dtype=torch.bfloat16)
    assert float(out[0, 0] + vals[0]) == 1.0
    got = segment_sum_gather(vals[None], None, None, seg, 1, out=out)
    assert got is out and float(got[0, 0]) == 1.0 + 4096 * 2.0 ** -8


# ---------------------------------------------------------------------------
# the in-memory trainer and run_fused
# ---------------------------------------------------------------------------

def admm_problem(seed=23, n_rows=240, nblocks=3):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    test_rows = synth_rows(rng, 80)
    vocab = jbuild_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    return data, vocab, test_rows


def jax_runs(data, vocab, test_rows, **kw):
    """The JAX trainer in float64 and in bfloat16."""
    return tuple(JTrainer(data, vocab, JConfig(dtype=dt, **kw),
                          test_rows=test_rows).run()
                 for dt in (jnp.float64, jnp.bfloat16))


BASE = dict(lambdas=[0.5, 5.0, 50.0], num_iters=4, test_loglik_per_iter=True)

ADMM_MODES = {
    "flat": ({}, "flat"),
    "flat-head4": (dict(head_size=4), "flat"),
    "per_block": (dict(flat_blocks=False), "per_block"),
    "head_block": (dict(pcg="head_block", head_size=4), "per_block"),
    "lanes": (dict(multi_rhs=False), "lanes"),
    "lanes-head4": (dict(multi_rhs=False, head_size=4), "lanes"),
    "dual_layout": (dict(dual_layout=True), "lanes"),
    "l1": (dict(regularizer=1), "flat"),
}


@pytest.mark.parametrize("name", list(ADMM_MODES))
def test_admm_bf16_matches_jax(name):
    kw, mode = ADMM_MODES[name]
    data, vocab, test_rows = admm_problem()
    want64, wantbf = jax_runs(data, vocab, test_rows, **BASE, **kw)
    trainer = AdmmTrainer(data, vocab,
                          AdmmConfig(dtype=torch.bfloat16, **BASE, **kw),
                          test_rows=test_rows, device="cpu")
    assert trainer.mode == mode
    assert trainer.prob.values.dtype == torch.bfloat16
    got = trainer.run()
    assert got.iterations == wantbf.iterations == want64.iterations == 4
    rel = PORT_REL[f"admm/{name}"]
    assert_rule(got.z, wantbf.z, want64.z, rel)
    assert_rule(got.u, wantbf.u, want64.u, rel)
    assert_logliks_rule(got.sample_loglik_history,
                        wantbf.sample_loglik_history,
                        want64.sample_loglik_history, rel)
    assert [list(d) for d in got.diff_history] == \
        [list(d) for d in want64.diff_history]
    assert len(got.solver_stats) == 4
    assert all(s["newton_trips"] > 0 for s in got.solver_stats)


@pytest.mark.parametrize("kw", [{}, dict(head_size=4),
                                dict(pcg="head_block", head_size=4)],
                         ids=["flat", "flat-head4", "head_block"])
def test_run_fused_bf16_equals_run(kw):
    """run_fused in bfloat16 runs the same state functions as run(): the
    same bits, trips, logliks and best model, its static state made in
    bfloat16 before the loop."""
    data, vocab, test_rows = admm_problem(seed=24)
    trainer = AdmmTrainer(data, vocab,
                          AdmmConfig(dtype=torch.bfloat16, **BASE, **kw),
                          test_rows=test_rows, device="cpu")
    a = trainer.run()
    b = trainer.run_fused(checkpoint_every=2, callback=lambda **_: None)
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.u, b.u)
    assert a.diff_history == b.diff_history
    assert a.sample_loglik_history == b.sample_loglik_history
    assert (a.best_lambda, a.best_loglik) == (b.best_lambda, b.best_loglik)
    assert b.solver_stats == [{
        k: sum(s[k] for s in a.solver_stats) for k in a.solver_stats[0]}]


# ---------------------------------------------------------------------------
# the streaming trainer
# ---------------------------------------------------------------------------

def stream_problem(seed=0, n_rows=400, split=(2, 2)):
    rng = np.random.default_rng(seed)
    rows = synth_rows(rng, n_rows)
    test_rows = synth_rows(rng, 100)
    vocab = jbuild_vocab(rows)
    nb = sum(split)
    blocks = [rows[i::nb] for i in range(nb)]
    groups, lo = [], 0
    for k in split:
        groups.append(pack_blocks(blocks[lo:lo + k], vocab))
        lo += k
    return groups, vocab, test_rows


RESIDENCY = {"device": {}, "host": dict(consensus_device=False),
             "streamed": dict(resident_head=False),
             "dense-wire": dict(resident_head=False, compact_wire=False)}


@pytest.mark.parametrize("kw", [dict(head_size=4),
                                dict(head_size=4, pcg="head_block")],
                         ids=["flat-head4", "head_block"])
def test_streaming_bf16_matches_jax_and_residency_bits(kw):
    """StreamingAdmmTrainer in bfloat16 (host values and head as pinned-
    ready torch.bfloat16 tensors) against the JAX streaming trainer, and
    every residency setting (device- and host-resident consensus, heads
    pinned or streamed, both wires) the same bits."""
    groups, vocab, test_rows = stream_problem()
    base = dict(lambdas=[1.0, 10.0], num_iters=4, test_loglik_per_iter=True,
                **kw)
    want64, wantbf = (JStreaming(groups, vocab, JConfig(dtype=dt, **base),
                                 test_rows=test_rows).run()
                      for dt in (jnp.float64, jnp.bfloat16))
    runs = {}
    for name, extra in RESIDENCY.items():
        tr = StreamingAdmmTrainer(groups, vocab,
                                  AdmmConfig(dtype=torch.bfloat16, **base),
                                  test_rows=test_rows, device="cpu", **extra)
        assert tr.groups[0].values.dtype == torch.bfloat16
        assert tr.groups[0].head.dtype == torch.bfloat16
        runs[name] = tr.run()
    got = runs["device"]
    assert got.iterations == want64.iterations == 4
    rel = PORT_REL["stream/" + ("head_block" if "pcg" in kw
                                else "flat-head4")]
    assert_rule(got.z, wantbf.z, want64.z, rel)
    assert_rule(got.u, wantbf.u, want64.u, rel)
    assert_logliks_rule(got.sample_loglik_history,
                        wantbf.sample_loglik_history,
                        want64.sample_loglik_history, rel)
    for name, other in runs.items():
        np.testing.assert_array_equal(other.z, got.z, err_msg=name)
        np.testing.assert_array_equal(other.u, got.u, err_msg=name)
        assert other.diff_history == got.diff_history, name


# ---------------------------------------------------------------------------
# the mesh trainers on gloo ranks
# ---------------------------------------------------------------------------

def test_mesh_trainers_bf16_match_jax_mesh(tmp_path):
    """FeatureShardedAdmmTrainer on a 1 x 2 (block x feat) grid and the
    block-mesh AdmmTrainer (per-block, head 4) on 2 gloo ranks, both in
    bfloat16, against the JAX trainers on the same grids of the
    conftest's virtual devices; every rank returns the same bits."""
    from mlease_tpu.parallel import cpu_devices, make_mesh
    from mlease_tpu.parallel.mesh import make_mesh_2d
    from mlease_tpu.train.feature_sharded import \
        FeatureShardedAdmmTrainer as JFS

    rows = synth_rows(np.random.default_rng(2), 240)
    fs_kw = dict(lambdas=[1.0, 10.0], num_iters=4, multi_rhs=True, pcg=True,
                 flat_blocks=False)
    mesh_kw = dict(lambdas=[0.5, 5.0], num_iters=4, flat_blocks=False,
                   head_size=4)
    blocks = [rows[i::3] for i in range(3)]
    runs = launch([
        ("fs", "fs", dict(blocks=blocks, grid=(1, 2),
                          config=dict(fs_kw, dtype="bfloat16"))),
        ("mesh", "admm", dict(rows=rows, nblocks=3, mesh=2,
                              config=dict(mesh_kw, dtype="bfloat16")))],
        2, tmp_path, timeout=150)
    for name in runs:
        first = runs[name][0]
        for r in runs[name][1:]:
            np.testing.assert_array_equal(r["z"], first["z"])
            np.testing.assert_array_equal(r["u"], first["u"])
    vocab = jbuild_vocab([r for b in blocks for r in b])
    data = pack_blocks(blocks, vocab)
    grid = make_mesh_2d(cpu_devices(), block=1, feat=2)
    want = [JFS(data, vocab, JConfig(dtype=dt, **fs_kw), mesh=grid).run()
            for dt in (jnp.float64, jnp.bfloat16)]
    got = runs["fs"][0]
    assert got["iterations"] == want[0].iterations
    assert_rule(got["z"], want[1].z, want[0].z, PORT_REL["mesh"])
    assert_rule(got["u"], want[1].u, want[0].u, PORT_REL["mesh"])

    vocab = jbuild_vocab(rows)
    data = pack_blocks(blocks, vocab)
    mesh = make_mesh(cpu_devices(), n=2)
    want = [JTrainer(data, vocab, JConfig(dtype=dt, **mesh_kw),
                     mesh=mesh).run() for dt in (jnp.float64, jnp.bfloat16)]
    got = runs["mesh"][0]
    assert got["iterations"] == want[0].iterations
    assert_rule(got["z"], want[1].z, want[0].z, PORT_REL["mesh"])
    assert_rule(got["u"], want[1].u, want[0].u, PORT_REL["mesh"])


# ---------------------------------------------------------------------------
# the naive trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["flat", "per_key", "lanes"])
def test_naive_bf16_matches_jax(branch):
    kw = {"flat": {}, "per_key": {"flat_blocks": False},
          "lanes": {"multi_rhs": False}}[branch]
    rng = np.random.default_rng(0)
    keyed = {"0": synth_rows(rng, 120), "1": synth_rows(rng, 150),
             "2": synth_rows(rng, 3)}
    rows = keyed["0"] + keyed["1"]
    base = dict(lambdas=[1.0, 4.0], liblinear_epsilon=1e-5,
                data_size_threshold=10, compute_model_mean=True, **kw)
    want64, wantbf = (jtrain_naive(keyed, JNaiveConfig(dtype=dt, **base),
                                   vocab=jbuild_vocab(rows))
                      for dt in (jnp.float64, jnp.bfloat16))
    got = train_naive(keyed, NaiveConfig(dtype=torch.bfloat16, **base),
                      vocab=build_vocab(rows), device="cpu")
    assert got.skipped_keys == wantbf.skipped_keys == ["2"]
    assert_models_rule(got.models, wantbf.models, want64.models,
                       PORT_REL["naive"])
    assert_models_rule(got.mean_models, wantbf.mean_models,
                       want64.mean_models, PORT_REL["naive"])


# ---------------------------------------------------------------------------
# the train CLI, its checkpoints and state_from_checkpoint
# ---------------------------------------------------------------------------

def write_job(path, props) -> str:
    with open(path, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in props.items())
    return str(path)


def bc_props(out, **extra) -> dict:
    props = dict(JobConfig.from_file(JOB))
    props.update({"input.paths": os.path.join(DATA, "train"),
                  "test.path": os.path.join(DATA, "test"),
                  "output.base.path": out, "num.iters": "6",
                  "dtype": "bfloat16"})
    props.update(extra)
    return props


def tree(root):
    out = set()
    for dirpath, _dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.split(os.sep)[0] in ("checkpoint", "tmp-data"):
            continue
        out.update(os.path.join(rel, f) for f in files)
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI on breast-cancer.job (6 iterations), the port's in
    bfloat16 and the JAX package's in bfloat16 and float64."""
    root = tmp_path_factory.mktemp("bf16-cli")
    outs = {}
    for tag, main, extra, dtype in (
            ("torch", tmain, ["--device", "cpu"], "bfloat16"),
            ("jax", jmain, [], "bfloat16"), ("jax64", jmain, [], "float64")):
        out = str(root / f"{tag}-out")
        job = write_job(root / f"{tag}.job", bc_props(out, dtype=dtype))
        assert main(["train", job, *extra]) == 0
        outs[tag] = (out, job)
    return outs


def test_train_cli_bf16_matches_jax(cli_runs, capsys):
    """The same output tree; final and best models and per-iteration
    sample logliks within the rule."""
    out_t, out_j, out_64 = (cli_runs[k][0] for k in ("torch", "jax",
                                                      "jax64"))
    assert tree(out_t) == tree(out_j)
    for sub in ("final-model",):
        models = [read_model_file(os.path.join(o, sub))
                  for o in (out_t, out_j, out_64)]
        assert_models_rule(*models, PORT_REL["train_cli"])
    files = sorted(os.listdir(os.path.join(out_j, "sample-test-loglik")))
    assert files == sorted(os.listdir(os.path.join(out_t,
                                                   "sample-test-loglik")))
    from mlease_tpu.io import avro
    lls = [[r for name in files for r in avro.read_records(
        os.path.join(o, "sample-test-loglik", name))]
        for o in (out_t, out_j, out_64)]
    assert_logliks_rule(*lls, PORT_REL["train_cli"])


def test_train_cli_bf16_checkpoints_and_resume(cli_runs, tmp_path):
    """The port's bfloat16 checkpoints are what the JAX package writes:
    |V2 arrays of the bf16 bits, JAX's shapes and manifests;
    state_from_checkpoint reads JAX's bf16 checkpoint (its values are the
    bits widened); resume=true on such a checkpoint raises in the port,
    as it fails in the JAX package."""
    out_t, job_t = cli_runs["torch"]
    out_j = cli_runs["jax"][0]
    names_t = sorted(os.listdir(os.path.join(out_t, "checkpoint")))
    assert names_t == sorted(os.listdir(os.path.join(out_j, "checkpoint")))
    for npz in (n for n in names_t if n.endswith(".npz")):
        a = np.load(os.path.join(out_t, "checkpoint", npz))
        b = np.load(os.path.join(out_j, "checkpoint", npz))
        for key in ("z", "u"):
            assert a[key].dtype == b[key].dtype == np.dtype("V2")
            assert a[key].shape == b[key].shape
    for js in (n for n in names_t if n.endswith(".json")):
        ma = json.load(open(os.path.join(out_t, "checkpoint", js)))
        mb = json.load(open(os.path.join(out_j, "checkpoint", js)))
        assert sorted(ma) == sorted(mb)
        assert ma["iteration"] == mb["iteration"]

    state = state_from_checkpoint(os.path.join(out_j, "checkpoint"))
    last = sorted(glob.glob(os.path.join(out_j, "checkpoint", "*.npz")))[-1]
    bits = np.load(last)["z"].view(np.uint16).astype(np.uint32) << 16
    np.testing.assert_array_equal(state["z0"], bits.view(np.float32))
    assert state["start_iteration"] == 7

    out = str(tmp_path / "resumed")
    shutil.copytree(out_t, out)
    props = dict(JobConfig.from_file(job_t))
    props.update({"resume": "true", "force.output.overwrite": "false",
                  "output.base.path": out})
    job = write_job(tmp_path / "resume.job", props)
    with pytest.raises(ValueError, match="bfloat16"):
        tmain(["train", job, "--device", "cpu"])


def test_streamed_and_fused_train_bf16(tmp_path):
    """The train job streamed in 2 groups through the pack cache (a cache
    the JAX package then loads as its own, and the manifest JAX writes),
    and under fused.loop: bfloat16 models within the rule of the JAX
    package's, the streamed checkpoints widened to float64 as JAX writes
    them, and the fused run's checkpoints every 2 iterations."""
    from mlease_tpu.train.pipeline import run_regression_pipeline as jp
    from mlease_tpu_torch.train.pipeline import \
        run_regression_pipeline as tp

    for extra in ({"streaming.groups": "2", "head.size": "4"},
                  {"fused.loop": "true", "checkpoint.every": "2"}):
        res = {}
        for tag in ("torch", "jax", "jax64"):
            out = str(tmp_path / f"{tag}-{len(res)}-{len(extra)}")
            e = dict(extra)
            if "streaming.groups" in e:
                e["pack.cache.dir"] = out + "-pc"
            props = bc_props(out, **e)
            if tag == "jax64":
                props["dtype"] = "float64"
            res[tag] = (out, (tp(JobConfig(props), device="cpu")
                              if tag == "torch" else jp(JobConfig(props))))
        (out_t, rt), (out_j, rj), (_o, r64) = (res[k] for k in
                                               ("torch", "jax", "jax64"))
        assert tree(out_t) == tree(out_j)
        assert_rule(rt.z, rj.z, r64.z, PORT_REL["streamed_and_fused"])
        names = sorted(os.listdir(os.path.join(out_t, "checkpoint")))
        assert names == sorted(os.listdir(os.path.join(out_j, "checkpoint")))
        last = [n for n in names if n.endswith(".npz")][-1]
        z_t = np.load(os.path.join(out_t, "checkpoint", last))["z"]
        z_j = np.load(os.path.join(out_j, "checkpoint", last))["z"]
        assert z_t.dtype == z_j.dtype and z_t.shape == z_j.shape
        if "streaming.groups" in extra:
            assert z_t.dtype == np.float64
            with open(out_t + "-pc/manifest.json") as f:
                m_t = json.load(f)
            with open(out_j + "-pc/manifest.json") as f:
                m_j = json.load(f)
            m_t.pop("inputs"), m_j.pop("inputs")
            assert m_t == m_j and m_t["head_dtype"] == "bfloat16"
            from mlease_tpu.io import pack_cache as jpc
            from mlease_tpu_torch.io import pack_cache as tpc
            loaded = jpc.load_groups(out_t + "-pc", json.load(
                open(out_t + "-pc/manifest.json")))
            assert loaded is not None
            assert loaded[0][0].head.dtype == np.dtype(jnp.bfloat16)
            mine = tpc.load_groups(out_t + "-pc", json.load(
                open(out_t + "-pc/manifest.json")))[0]
            np.testing.assert_array_equal(
                loaded[0][0].head.view(np.uint16),
                mine[0].head.view(torch.int16).numpy().view(np.uint16))
        else:
            assert last == "iter-00006.npz" and \
                names[0] == "iter-00004.json"
            assert z_t.dtype == np.dtype("V2")


# ---------------------------------------------------------------------------
# the naive and item CLIs
# ---------------------------------------------------------------------------

def test_naive_and_item_cli_bf16_match_jax(tmp_path, capsys):
    """`naive` and `item` with dtype=bfloat16 end to end, the port's and the
    JAX package's: the same model keys and files, models within the
    rule."""
    from test_torch_cli import _naive_avro
    from test_torch_item_score import ITEM_SCHEMA
    from mlease_tpu_torch.io import avro as tavro

    data = _naive_avro(tmp_path)
    rng = np.random.default_rng(1)
    recs = [{"item": f"it{i % 4}", "response": int(rng.integers(0, 2)),
             "features": [{"name": f"f{int(j)}", "term": "",
                           "value": float(v)}
                          for j, v in zip(rng.choice(4, 2, replace=False),
                                          rng.normal(size=2))],
             "weight": 1.0, "offset": float(rng.normal() * 0.1)}
            for i in range(240)]
    items = str(tmp_path / "items.avro")
    tavro.write_records(items, ITEM_SCHEMA, recs)
    jobs = {
        "naive": ({"input.paths": data, "lambda": "1,5", "num.blocks": "3",
                   "compute.model.mean": "true", "liblinear.epsilon": "1e-6"},
                  ("models", "final-model"), "output.base.path"),
        "item": ({"input.paths": items, "item.key": "item",
                  "intercept.lambdas": "1", "default.lambdas": "1,4",
                  "liblinear.epsilon": "1e-6", "native.ingest": "false"},
                 ("",), "output.model.path"),
    }
    for cmd, (props, subs, out_key) in jobs.items():
        outs = {}
        for tag, main, extra, dtype in (
                ("torch", tmain, ["--device", "cpu"], "bfloat16"),
                ("jax", jmain, [], "bfloat16"),
                ("jax64", jmain, [], "float64")):
            out = str(tmp_path / f"{cmd}-{tag}")
            job = write_job(tmp_path / f"{cmd}-{tag}.job",
                            {**props, out_key: out, "dtype": dtype})
            assert main([cmd, job, *extra]) == 0
            capsys.readouterr()
            outs[tag] = out
        for sub in subs:
            models = [read_model_file(os.path.join(outs[t], sub))
                      for t in ("torch", "jax", "jax64")]
            assert sorted(os.listdir(os.path.join(outs["torch"], sub))) == \
                sorted(os.listdir(os.path.join(outs["jax"], sub)))
            assert_models_rule(*models, PORT_REL["naive_item_cli"])


# ---------------------------------------------------------------------------
# the streaming floor's tables
# ---------------------------------------------------------------------------

def test_floor_takes_a_bf16_table_only_for_a_bf16_run(tmp_path, monkeypatch):
    """A bfloat16 streamed run's pass-floor decomposition takes a table
    measured in bfloat16 ("dtype": "bfloat16", named in "source") or says
    that none applies; it never takes a float32 table, and a float32 or
    float64 run never takes a bfloat16 one."""
    from mlease_tpu_torch.utils import floor as tfloor
    from test_torch_floor import groups_of, table, write

    monkeypatch.delenv("BENCH_FLOORS", raising=False)
    monkeypatch.setattr(tfloor, "TOOLS_DIR", str(tmp_path))
    f32_tab = table()
    bf16_tab = dict(table(rows=128), dtype="bfloat16")
    groups = groups_of()[0]
    trip_log = [np.ones((2, 2))]
    write(tmp_path / "torch_pass_floors.json", f32_tab)
    out = tfloor.streaming_floor(groups, trip_log, 1, 0.1, None, 2,
                                 device="cpu", dtype=torch.bfloat16)
    assert out["util"] is None and "measured in float32 compute, running " \
        "in bfloat16" in out["source"]
    write(tmp_path / "torch_pass_floors_bf16.json", bf16_tab)
    out = tfloor.streaming_floor(groups, trip_log, 1, 0.1, None, 2,
                                 device="cpu", dtype=torch.bfloat16)
    assert out["util"] is not None
    assert out["source"].startswith("composed from probe table @ cpu "
                                    "(bfloat16 compute, ")
    for dt in (torch.float32, torch.float64, None):
        tab, why = tfloor.load_floor_table(device="cpu", dtype=dt)
        assert why is None and tab == f32_tab
    tab, why = tfloor.load_floor_table(device="cpu", dtype=torch.bfloat16)
    assert why is None and tab == bf16_tab
