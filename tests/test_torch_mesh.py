"""The port's mesh (mlease_tpu_torch.parallel, AdmmTrainer(mesh=...),
build_admm_step(group=...)) against the JAX package's, float64 on the CPU:
W gloo ranks of the port (tests/torch_mesh_worker.py, one process each, no
JAX) against W of the conftest's virtual CPU devices, the same rows from
tests/test_admm.py::synth_rows.

Tolerances: z and u to 1e-8 * max|z| with equal Newton and CG trip counts
per iteration (each per-block solve agrees to ~1e-12, and the block sums
only change their order); every rank returns the same z, bit for bit; the
port on W ranks against its own no-mesh per-block run to 1e-12, and on one
rank bit for bit (the same sums in the same order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mlease_tpu.core import build_vocab, pack_blocks
from mlease_tpu.core.dataset import to_hybrid
from mlease_tpu.parallel import cpu_devices, make_mesh as jax_make_mesh
from mlease_tpu.parallel import pad_blocks as jax_pad_blocks
from mlease_tpu.train.admm import AdmmConfig as JConfig
from mlease_tpu.train.admm import AdmmTrainer as JTrainer
from mlease_tpu_torch import parallel
from mlease_tpu_torch.parallel import distributed
from mlease_tpu_torch.parallel.mesh import Sharding, make_mesh_2d
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

from test_admm import synth_rows
from torch_mesh_worker import launch

torch.set_num_threads(1)

LAMBDAS = [1.0, 10.0]


def rows_of(seed=21, n=400, n_test=80):
    rng = np.random.default_rng(seed)
    return synth_rows(rng, n), synth_rows(rng, n_test)


def jax_run(rows, nblocks, cfg, world=None, test_rows=None):
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::nblocks] for i in range(nblocks)], vocab)
    mesh = None if world is None else jax_make_mesh(cpu_devices(), n=world)
    return JTrainer(data, vocab, JConfig(dtype=jnp.float64, **cfg),
                    test_rows=test_rows, mesh=mesh).run()


def assert_matches(got, want, rel=1e-8):
    """got: the port's result (a dict from a rank), want: an AdmmResult."""
    atol = rel * float(np.abs(want.z).max())
    assert got["iterations"] == want.iterations
    assert got["u"].shape == want.u.shape
    np.testing.assert_allclose(got["z"], want.z, rtol=0, atol=atol)
    np.testing.assert_allclose(got["u"], want.u, rtol=0, atol=atol)
    assert got["solver_stats"] == [{k: int(v) for k, v in s.items()}
                                   for s in want.solver_stats]
    for g, w in zip(got["sample_loglik_history"],
                    want.sample_loglik_history):
        assert (g["lambda"], g["iter"]) == (w["lambda"], w["iter"])
        assert g["testLoglik"] == pytest.approx(w["testLoglik"], abs=1e-9)


def assert_ranks_agree(per_rank):
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r["z"], per_rank[0]["z"])
        np.testing.assert_array_equal(r["u"], per_rank[0]["u"])
        assert r["solver_stats"] == per_rank[0]["solver_stats"]


# (name, nblocks, world, mode): 8 blocks over 3 ranks and 5 over 3 pad
MODES = {
    "jacobi": dict(flat_blocks=False, pcg=True),
    "flat_key": dict(flat_blocks=True, pcg=True),   # never flat on a mesh
    "head_block": dict(pcg="head_block", head_size=4),
    "jacobi_head": dict(flat_blocks=False, pcg=True, head_size=4),
    "lanes": dict(multi_rhs=False, head_size=4),
    "reference_cg": dict(flat_blocks=False, pcg=False),
}
CASES = [("jacobi-8-2", 8, 2, "jacobi"), ("flat_key-6-2", 6, 2, "flat_key"),
         ("head_block-8-2", 8, 2, "head_block"),
         ("jacobi_head-8-2", 8, 2, "jacobi_head"),
         ("lanes-8-2", 8, 2, "lanes"),
         ("reference_cg-8-3", 8, 3, "reference_cg"),
         ("jacobi_head-8-3", 8, 3, "jacobi_head"),
         ("head_block-5-3", 5, 3, "head_block")]


def case_config(mode, n_iters=4):
    return dict(lambdas=LAMBDAS, num_iters=n_iters,
                test_loglik_per_iter=True, **MODES[mode])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rows, test_rows = rows_of()
    out = {}
    for world in (2, 3):
        cases = [(name, "admm", dict(
            rows=rows, nblocks=nb, mesh=world, test_rows=test_rows,
            config=dict(case_config(mode), dtype="float64")))
            for name, nb, w, mode in CASES if w == world]
        if world == 2:
            cases.append(("multiproc", "multiproc",
                          dict(rows=rows_of(0)[0], nblocks=8, iters=4)))
        out.update(launch(cases, world, tmp_path_factory.mktemp(
            f"mesh{world}"), timeout=150))
    return out, rows, test_rows


@pytest.mark.parametrize("name,nblocks,world,mode", CASES,
                         ids=[c[0] for c in CASES])
def test_mesh_matches_jax_mesh(runs, name, nblocks, world, mode):
    """AdmmTrainer(mesh=) on W ranks == the JAX trainer on a W-device mesh
    (the per-block solve: Jacobi, head-block with K2's plain version on each
    rank's heads, lanes, the reference CG; with a head each rank's per-block
    solve runs K1's plain version), every rank holding the same result."""
    res, rows, test_rows = runs
    per_rank = res[name]
    assert_ranks_agree(per_rank)
    want = jax_run(rows, nblocks, case_config(mode), world, test_rows)
    assert per_rank[0]["mode"] == ("lanes" if mode == "lanes"
                                   else "per_block")
    assert per_rank[0]["u"].shape == (len(LAMBDAS), nblocks,
                                      want.z.shape[1])
    assert_matches(per_rank[0], want)


def test_mesh_matches_the_ports_own_per_block_run(runs):
    """W ranks against the port's no-mesh per-block run of the same data:
    the block sums only change their order (1e-12)."""
    res, rows, test_rows = runs
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::8] for i in range(8)], vocab)
    for name, mode in (("jacobi-8-2", "jacobi"),
                       ("jacobi_head-8-3", "jacobi_head")):
        want = AdmmTrainer(data, vocab, AdmmConfig(
            dtype=torch.float64, **case_config(mode)), test_rows=test_rows,
            device="cpu").run()
        got = res[name][0]
        atol = 1e-12 * float(np.abs(want.z).max())
        np.testing.assert_allclose(got["z"], want.z, rtol=0, atol=atol)
        np.testing.assert_allclose(got["u"], want.u, rtol=0, atol=atol)
        assert got["solver_stats"] == want.solver_stats


def test_two_process_host_block_range_matches_single(runs):
    """The multi-host path (tests/test_multiprocess.py): 2 ranks each take
    host_block_range(8) of the blocks through make_global_blocked_arrays
    and run build_admm_step(group=) 4 times; ZSUM == the JAX
    single-process run."""
    res, _rows, _t = runs
    per_rank = res["multiproc"]
    assert [r["range"] for r in per_rank] == [(0, 4), (4, 8)]
    assert per_rank[0]["zsum"] == per_rank[1]["zsum"]
    rows = rows_of(0)[0]
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::8] for i in range(8)], vocab)
    cfg = JConfig(lambdas=[1.0], rhos=[1.0], num_iters=4, dtype=jnp.float64,
                  multi_rhs=True, pcg=True, flat_blocks=False)
    want = JTrainer(data, vocab, cfg).run()
    assert per_rank[0]["zsum"] == pytest.approx(
        float(np.abs(want.z).sum()), rel=1e-9)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    assert not dist.is_initialized()
    distributed.initialize("cpu", init_method=f"file://{tmp_path}/pg",
                           world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_is_bit_for_bit_the_per_block_run(one_rank_group):
    """A mesh of one rank runs the no-mesh per-block trainer's arithmetic
    exactly: the same z, u and trips bit for bit, in every mode that has
    a mesh form."""
    rows, test_rows = rows_of(seed=3, n=240)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[i::3] for i in range(3)], vocab)
    mesh = parallel.make_mesh(1, "cpu")
    for mode in ("jacobi", "head_block", "lanes"):
        cfg = AdmmConfig(dtype=torch.float64, **case_config(mode, 3))
        plain = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                            device="cpu")
        meshed = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                             mesh=mesh)
        assert plain.mode == meshed.mode
        a, b = plain.run(), meshed.run()
        np.testing.assert_array_equal(b.z, a.z)
        np.testing.assert_array_equal(b.u, a.u)
        assert b.solver_stats == a.solver_stats
        assert b.sample_loglik_history == a.sample_loglik_history


def test_make_mesh_needs_a_group_of_its_size(one_rank_group):
    mesh = parallel.make_mesh(None, "cpu")
    assert mesh.mesh_dim_names == (parallel.BLOCK_AXIS,)
    assert tuple(mesh.shape) == (1,)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        parallel.make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh_2d(1, 2, "cpu")
    assert distributed.host_block_range(5) == (0, 5)
    parts = parallel.shard_blocked_arrays(mesh, {
        "y": np.ones((3, 4)), "u": np.zeros((2, 3, 5)), "z": np.ones(5)})
    assert [parts[k].shape for k in ("y", "u", "z")] == [(3, 4), (2, 3, 5),
                                                         (5,)]
    assert parallel.block_sharding(mesh, 1) == Sharding(1, 0, 1)
    assert parallel.replicated(mesh) == Sharding(None)
    with pytest.raises(ValueError, match="ranks hold 3 blocks"):
        distributed.make_global_blocked_arrays(
            mesh, {"y": np.zeros((3, 4))}, 4)
    got = distributed.make_global_blocked_arrays(
        mesh, {"y": np.ones((3, 4)), "u": np.zeros((2, 3, 5))}, 3)
    assert got["y"].shape == (3, 4) and got["u"].shape == (2, 3, 5)


def test_make_mesh_without_a_group_names_the_launcher(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        parallel.make_mesh(2, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.make_mesh(1)
    distributed.initialize("cpu")          # no launcher, no arguments
    assert not dist.is_initialized()


@pytest.mark.parametrize("head", [0, 4])
def test_pad_blocks_matches_jax(head):
    rows, _t = rows_of(seed=2, n=50)
    vocab = build_vocab(rows)
    data = pack_blocks([rows[:25], rows[25:]], vocab)
    if head:
        data = to_hybrid(data, head)
    got, valid = parallel.pad_blocks(data, 8)
    want, want_valid = jax_pad_blocks(data, 8)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(valid, [1, 1, 0, 0, 0, 0, 0, 0])
    assert got.nblocks == want.nblocks == 8
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert got.weight[2:].sum() == 0 and not got.present[2:].any()
    same, v = parallel.pad_blocks(data, 2)
    assert same is data and v.tolist() == [1.0, 1.0]


def test_sharding_takes_contiguous_slices():
    a = np.arange(24).reshape(2, 6, 2)
    np.testing.assert_array_equal(Sharding(1, 2, 3).take(a), a[:, 4:6])
    np.testing.assert_array_equal(Sharding(0, 1, 2).take(a), a[1:2])
    assert Sharding(None).take(a) is a
    with pytest.raises(ValueError, match="pad_blocks"):
        Sharding(1, 0, 4).take(a)


def test_no_worker_of_this_file_leaks_jax():
    """The rank script itself imports nothing of JAX (its ranks assert it
    at exit too)."""
    src = open(os.path.join(os.path.dirname(__file__),
                            "torch_mesh_worker.py")).read()
    assert "import jax" not in src and "from mlease_tpu." not in src
