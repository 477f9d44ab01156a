"""One rank of the port's mesh, for the multi-rank tests (tests/
test_torch_mesh.py and the mesh cases of the other test_torch_* files).

    python tests/torch_mesh_worker.py SPEC RANK WORLD INIT_FILE OUT_DIR

SPEC is a pickle of {"cases": [(name, kind, params), ...], "device": ...}:
plain Python and numpy values only (rows as dicts, configs as keyword
dicts), so that a rank imports torch and the port and never JAX. Every rank
joins a gloo process group through a file:// store (no TCP port, so
concurrent test workers never collide), runs every case in order on the
CPU (or, with "device": "cuda", on the card, gloo over CUDA tensors), one
torch thread, and writes its own result of case NAME to
OUT_DIR/NAME.RANK.pkl.

`launch()` starts the ranks from a test and holds them to a deadline: a
hung collective kills every rank and fails the test, not the suite.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def launch(cases, world: int, tmp_path, timeout: float = 120.0,
           device: str = "cpu") -> dict:
    """Run `cases` on `world` ranks; returns {name: [result of rank r]}."""
    tmp = str(tmp_path)
    spec = os.path.join(tmp, f"spec-{world}.pkl")
    out = os.path.join(tmp, f"out-{world}")
    os.makedirs(out, exist_ok=True)
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "device": device}, f)
    init = os.path.join(tmp, f"pg-{world}-{time.monotonic_ns()}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec, str(r), str(world),
         init, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    logs = [""] * world
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        raise AssertionError(
            f"mesh ranks exceeded the {timeout:.0f} s deadline")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            # a failed rank leaves its partners blocked in a collective
            for q in procs:
                if q.poll() is None:
                    q.kill()
            raise AssertionError(f"rank {r} failed:\n{logs[r][-4000:]}")
    results = {}
    for name, _kind, _params in cases:
        results[name] = []
        for r in range(world):
            with open(os.path.join(out, f"{name}.{r}.pkl"), "rb") as f:
                results[name].append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the rank side: nothing below imports JAX
# ---------------------------------------------------------------------------

def _torch_dtype(name):
    import torch
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16, None: None}[name]


def _admm_config(kw):
    from mlease_tpu_torch.train.admm import AdmmConfig
    kw = dict(kw)
    kw["dtype"] = _torch_dtype(kw.get("dtype", "float64"))
    if "head_dtype" in kw:
        kw["head_dtype"] = _torch_dtype(kw["head_dtype"])
    return AdmmConfig(**kw)


def _packed(p):
    """(blocks, vocab, BlockedData) of params with "rows" and "nblocks"
    (blocks rows[i::nblocks]), or "blocks" (a list of row lists)."""
    from mlease_tpu_torch.core import build_vocab, pack_blocks
    blocks = p.get("blocks") or [p["rows"][i::p["nblocks"]]
                                 for i in range(p["nblocks"])]
    # the vocabulary of the rows in the order the test built its own from
    vocab = build_vocab(p["rows"] if "rows" in p
                        else [r for b in blocks for r in b])
    return blocks, vocab, pack_blocks(blocks, vocab)


def _result(res):
    return {"z": res.z, "u": res.u, "iterations": res.iterations,
            "solver_stats": res.solver_stats,
            "diff_history": res.diff_history,
            "sample_loglik_history": res.sample_loglik_history,
            "best_lambda": res.best_lambda, "best_loglik": res.best_loglik,
            "converged": res.converged}


def case_admm(p):
    """One mesh run; with "resume_at": k, stopped after iteration k (the
    callback's gathered state, as the pipeline checkpoints it) and resumed
    by a new trainer from that state; with "fused": "fused", run_fused
    (with "checkpoint_every": C, its callback's chunk ends, loglik counts
    and gathered u kept)."""
    from mlease_tpu_torch.parallel import make_mesh
    from mlease_tpu_torch.train.admm import AdmmTrainer
    _b, vocab, data = _packed(p)
    mesh = make_mesh(p.get("mesh"), "cpu")
    cfg = _admm_config(p["config"])
    tr = AdmmTrainer(data, vocab, cfg, test_rows=p.get("test_rows"),
                     mesh=mesh)
    if p.get("fused") == "fused":
        calls, chunk_u = [], []

        def chunk(iteration, z, u, diffs, inner_eps, logliks=None):
            calls.append((iteration, len(logliks or [])))
            chunk_u.append(u.numpy().copy())
        out = _result(tr.run_fused(
            checkpoint_every=p.get("checkpoint_every"),
            callback=chunk if p.get("checkpoint_every") else None))
        out.update(mode=tr.mode, calls=calls, chunk_u=chunk_u)
        return out
    k = p.get("resume_at")
    if k is None:
        out = _result(tr.run())
        out["mode"] = tr.mode
        return out
    state = {}

    def keep(iteration, z, u, diffs, inner_eps, logliks=None):
        if iteration == k:
            state.update(z0=z.numpy().copy(), u0=u.numpy().copy(),
                         start_iteration=k + 1, inner_eps0=inner_eps,
                         mindiff0=float(diffs.min()))
    tr.config = type(cfg)(**dict(cfg.__dict__, num_iters=k))
    tr.run(callback=keep)
    tr2 = AdmmTrainer(data, vocab, cfg, test_rows=p.get("test_rows"),
                      mesh=mesh)
    out = _result(tr2.run(**state))
    out["u0_shape"] = state["u0"].shape
    return out


def case_multiproc(p):
    """Each rank packs its host_block_range of the blocks and runs
    build_admm_step on them (the JAX package's multi-host path,
    tests/multiproc_worker.py); returns sum|z| after p["iters"]."""
    import torch
    from mlease_tpu_torch.ops.objective import class_balance_eps_scale
    from mlease_tpu_torch.ops.tron_multi import stack_blocks
    from mlease_tpu_torch.parallel import BLOCK_AXIS, distributed
    from mlease_tpu_torch.train.admm import build_admm_step

    blocks, vocab, data = _packed(p)
    nb = len(blocks)
    mesh = distributed.global_mesh("cpu")
    lo, hi = distributed.host_block_range(nb)
    arrs = distributed.make_global_blocked_arrays(mesh, {
        k: getattr(data, k)[lo:hi] for k in (
            "indices", "values", "y", "weight", "offset", "present")}, nb)
    n, L, dt = data.dim, 1, torch.float64
    step = build_admm_step(
        nblocks=nb, regularizer=2, intercept_index=vocab.intercept_index,
        penalize_intercept=False, reference_l1_compat=False,
        max_newton_iter=1000, max_cg_iter=500, mode="per_block", pcg=True,
        group=mesh.get_group(BLOCK_AXIS))
    B = hi - lo
    prob = stack_blocks(arrs["indices"], arrs["values"].to(dt),
                        arrs["y"].to(dt), arrs["weight"].to(dt),
                        arrs["offset"].to(dt), (None,) * 8,
                        torch.zeros((L, B, n), dtype=dt),
                        torch.ones(L, dtype=dt))
    z = torch.zeros((L, n), dtype=dt)
    u = torch.zeros((L, B, n), dtype=dt)
    lam = torch.ones((L, n), dtype=dt)
    rho = torch.ones(L, dtype=dt)
    eps = 0.01 * torch.as_tensor(class_balance_eps_scale(
        data.y[lo:hi], data.nrows[lo:hi]), dtype=dt)
    for _ in range(p["iters"]):
        z, u, _d, _s = step(prob, arrs["present"], z, u, lam, rho, rho, eps)
    return {"zsum": float(z.abs().sum()), "z": z.numpy(),
            "range": (lo, hi)}


def case_streaming(p):
    from mlease_tpu_torch.core import pack_blocks
    from mlease_tpu_torch.parallel import make_mesh
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    blocks, vocab, _d = _packed(p)
    groups, lo = [], 0
    for k in p["split"]:
        groups.append(pack_blocks(blocks[lo:lo + k], vocab))
        lo += k
    tr = StreamingAdmmTrainer(groups, vocab, _admm_config(p["config"]),
                              test_rows=p.get("test_rows"),
                              mesh=make_mesh(p.get("mesh"), "cpu"),
                              **p.get("kw", {}))
    out = _result(tr.run())
    out.update(mode=tr.mode, trip_log=tr.trip_log,
               residency=tr.residency_report())
    return out


def case_fs(p):
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    _b, vocab, data = _packed(p)
    db, df = p["grid"]
    mesh = make_mesh_2d(db, df, "cpu")
    tr = FeatureShardedAdmmTrainer(data, vocab, _admm_config(p["config"]),
                                   test_rows=p.get("test_rows"), mesh=mesh)
    return _result(tr.run())


def case_fs_loop(p):
    """The feature-sharded trainer's run() on its device loop, twice (the
    loop made once and kept), then with the seam `_x_update` set to the
    host-driven `_host_x_update` (step()'s solve); and one iteration from
    random z and u (seeded by this rank's shard and block row) through
    step() and through the loop."""
    import numpy as np
    import torch
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    _b, vocab, data = _packed(p)
    tr = FeatureShardedAdmmTrainer(data, vocab, _admm_config(p["config"]),
                                   test_rows=p.get("test_rows"),
                                   mesh=make_mesh_2d(*p["grid"], "cpu"))
    out = {"loop": _result(tr.run()), "loop_again": _result(tr.run()),
           "loops_made": len(tr._loops),
           "branches": tr._loops["x"].loop.counts()["branch_executions"]}
    tr._x_update = tr._host_x_update
    out["host"] = _result(tr.run())
    del tr._x_update

    cfg, dt = tr.config, tr.config.dtype
    b = int(tr.mesh.get_coordinate()[0])
    L, nl, B = len(tr.lambdas), tr.fs.n_local, tr.present.shape[0]
    rng = np.random.default_rng(100 * tr._shard + 7)
    z = torch.as_tensor(rng.normal(size=(L, nl)) * 0.1, dtype=dt)
    rng = np.random.default_rng(100 * tr._shard + b)
    u = torch.as_tensor(rng.normal(size=(L, B, nl)) * 0.1, dtype=dt)
    rho = torch.as_tensor(tr.rhos, dtype=dt)
    eps = cfg.liblinear_epsilon * tr.eps_scale
    z_s, u_s, d_s, t_s = tr.step(z, u, rho, rho, eps)
    x, trips = tr._x_update(z, u, rho, eps)
    z_l, u_l, d_l = tr._consensus(x, z, u, rho)

    def host(t):
        return t.to(torch.float64).numpy()
    out["one_step"] = {
        "step": [host(z_s), host(u_s), host(d_s), t_s],
        "loop": [host(z_l), host(u_l), host(d_l),
                 tr._trip_max(trips).numpy()]}
    return out


def case_fs_gloo_cuda(p):
    """On the card: run() of a feature-sharded trainer whose feat group is
    gloo over this many ranks raises ValueError before any loop is made;
    run() with the seam on the host-driven solve runs."""
    import numpy as np
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    _b, vocab, data = _packed(p)
    tr = FeatureShardedAdmmTrainer(data, vocab, _admm_config(p["config"]),
                                   mesh=make_mesh_2d(*p["grid"], "cuda"))
    out = {"error": None}
    try:
        tr.run()
    except ValueError as e:
        out["error"] = str(e)
    out["loops_made"] = len(tr._loops)
    tr._x_update = tr._host_x_update
    res = tr.run()
    out.update(z_finite=bool(np.isfinite(res.z).all()),
               iterations=res.iterations)
    return out


def case_fs_api(p):
    """The feature-sharded trainer's sample_loglik on this rank's z shard
    alone and with the gathered z_host; xv, fun and hv with group= on this
    rank's shard of the stacked problem (W, S, the prior mean: the full
    (B*n, L) or (L, B, n) arrays of p, sharded here; Dm (R, L))."""
    import numpy as np
    import torch
    from mlease_tpu_torch.core.feature_shard import shard_feature_vector
    from mlease_tpu_torch.ops import tron_multi as tm
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    _b, vocab, data = _packed(p)
    mesh = make_mesh_2d(*p["grid"], "cpu")
    tr = FeatureShardedAdmmTrainer(data, vocab, _admm_config(p["config"]),
                                   test_rows=p["test_rows"], mesh=mesh)
    S, nl, s = tr.fs.n_shards, tr.fs.n_local, tr._shard
    B = data.nblocks

    def shard(v):             # (..., B*n) stacked -> this rank's (..., B*nl)
        v = v.reshape(*v.shape[:-1], B, data.dim)
        return torch.as_tensor(shard_feature_vector(v, S, nl)[s].reshape(
            *v.shape[:-2], B * nl))
    z = torch.as_tensor(shard_feature_vector(p["z"], S, nl)[s])
    prob = tm.with_prior(tr.prob, shard(p["prior_mean"]).reshape(-1, B, nl),
                         torch.as_tensor(p["rho"]))
    W, S_ = shard(p["W"].T).T, shard(p["S"].T).T
    Dm = torch.as_tensor(p["Dm"])
    group = tr._feat_group
    return {"ll_z": tr.sample_loglik(z),
            "ll_host": tr.sample_loglik(z, p["z"]),
            "xv": tm.xv(prob, W, group=group).numpy(),
            "fun": tm.fun(prob, W, group=group).numpy(),
            "hv": tm.hv(prob, Dm, S_, group=group).numpy(),
            "shard": s, "n_local": nl}


def case_naive(p):
    from mlease_tpu_torch.core import build_vocab
    from mlease_tpu_torch.parallel import make_mesh
    from mlease_tpu_torch.train.naive import NaiveConfig, train_naive
    keyed = p["keyed"]
    vocab = build_vocab([r for k in sorted(keyed) for r in keyed[k]])
    kw = dict(p["config"])
    kw["dtype"] = _torch_dtype(kw.get("dtype", "float64"))
    res = train_naive(keyed, NaiveConfig(**kw), vocab=vocab,
                      mesh=make_mesh(p.get("mesh"), "cpu"))
    return {"models": {k: m.to_dense(vocab) for k, m in res.models.items()},
            "mean": None if res.mean_models is None else {
                k: m.to_dense(vocab) for k, m in res.mean_models.items()},
            "skipped": res.skipped_keys, "names": vocab.names,
            "trips": _trips(res.solver_stats)}


def _trips(stats):
    """A solver_stats dict without its host timings (the *_s keys)."""
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


def case_item(p):
    from mlease_tpu_torch.parallel import make_mesh
    from mlease_tpu_torch.train.item import ItemConfig, train_item_models
    kw = dict(p["config"])
    kw["dtype"] = _torch_dtype(kw.get("dtype", "float64"))
    res = train_item_models(p["keyed"], ItemConfig(**kw),
                            mesh=make_mesh(p.get("mesh"), "cpu"))

    def plain(models):
        return {k: (m.intercept, dict(m.coefficients))
                for k, m in models.items()}
    return {"models": plain(res.models), "pvar": plain(res.posterior_var),
            "cov": res.covariances,
            "stats": [_trips(s) for s in res.solver_stats]}


def case_pipeline(p):
    from mlease_tpu_torch.train.pipeline import run_regression_pipeline
    from mlease_tpu_torch.utils.config import JobConfig
    return _result(run_regression_pipeline(JobConfig(p["props"]),
                                           device="cpu"))


CASES = {"admm": case_admm, "multiproc": case_multiproc,
         "streaming": case_streaming, "fs": case_fs,
         "fs_loop": case_fs_loop, "fs_gloo_cuda": case_fs_gloo_cuda,
         "fs_api": case_fs_api, "naive": case_naive,
         "item": case_item, "pipeline": case_pipeline}


def main(argv):
    spec, rank, world, init, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from mlease_tpu_torch.parallel import distributed
    with open(spec, "rb") as f:
        spec = pickle.load(f)
    distributed.initialize(spec.get("device", "cpu"), backend="gloo",
                           init_method=f"file://{init}", world_size=world,
                           rank=rank)
    for name, kind, params in spec["cases"]:
        res = CASES[kind](params)
        with open(os.path.join(out, f"{name}.{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    assert "jax" not in sys.modules, "a rank imported JAX"
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
