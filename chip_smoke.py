#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (mlease_tpu_torch) on one H100.

    python3 chip_smoke.py [--seed 0] [--rows-per-block 1562500] [--iters 3]
                          [--out FILE.json]

Phases, each of which fails the run when it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the port's kernel (mlease_tpu_torch/csrc/segment_sum.cu) with
     nvcc from the sources in this checkout;
  3. kernel phase: `segment_sum_sorted` against its plain version on the
     card, at the main path's tail streams (the bench-default shape and the
     full-width shape of phase 5), float32 with L=3 and L=6 lanes and
     float64, plus empty segments and one giant segment; per segment
     |kernel - ref64| <= 1e-5 * sum|contrib| (float32), 1e-12 (float64);
     times from CUDA events over >= 20 repeats;
  4. CLI phase: `python -m mlease_tpu_torch train` on a copy of
     examples/data/breast-cancer.job (float64, head.size=16), output in a
     temporary directory; checks the output layout, finite logliks and
     that the kernel was launched;
  5. full-width phase (the main path): AdmmTrainer at the widths of
     examples/data/ctr-12m.job (1,000,001 columns, 12 nnz/row on zipf 1.3,
     head.size=128, 8 blocks, lambda 1/10/100, float32, Jacobi PCG, flat
     blocks) on synthetic data made from --seed, 8 x --rows-per-block rows
     (by default ctr-12m.job's 12.5M, uncut); the kernel's launch count is read from exactly
     this run; then the first iteration again with the plain reduce,
     max|z_kernel - z_plain| <= 1e-4 * max|z|;
  6. speed phase: ADMM iterations/s at bench.py's default shape (4 x 16,384
     rows, 50K features, 15 nnz, head 512) and at the full width, and one
     ADMM step of each under torch.profiler (device busy share, time by
     kernel).

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# peak rates outside the tensor cores (H100 SXM data sheet), FLOP/s
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
CLI_TIMEOUT_S = 300


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synth_blocked_data(n_features, nblocks, rows_per_block, nnz, seed):
    """Power-law CTR-like blocks, the generator of the JAX package's
    bench.py (zipf 1.3 column draw, intercept appended to every row)."""
    import numpy as np
    from mlease_tpu_torch.core.dataset import BlockedData

    rng = np.random.default_rng(seed)
    n = n_features + 1
    icpt = n_features
    B, R = nblocks, rows_per_block
    raw = rng.zipf(1.3, size=(B, R, nnz)).astype(np.int64)
    cols = (raw - 1) % n_features
    indices = np.concatenate(
        [cols, np.full((B, R, 1), icpt, dtype=np.int64)],
        axis=2).astype(np.int32)
    values = np.concatenate(
        [rng.normal(size=(B, R, nnz)).astype(np.float32) * 0.5,
         np.ones((B, R, 1), dtype=np.float32)], axis=2)
    w_true = (rng.normal(size=n) * 0.3).astype(np.float32)
    w_true[icpt] = -1.5
    scores = np.einsum("brk,brk->br", values,
                       w_true[indices]).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-scores))
    y = np.where(rng.random((B, R)) < p, 1.0, -1.0).astype(np.float32)
    present = np.zeros((B, n), dtype=bool)
    for b in range(B):
        present[b, np.unique(indices[b])] = True
    return BlockedData(
        indices=indices, values=values, y=y,
        weight=np.ones((B, R), np.float32),
        offset=np.zeros((B, R), np.float32), present=present,
        nrows=np.full(B, R, np.int32), nblocks=B, dim=n)


def make_vocab(n_features):
    from mlease_tpu_torch.core.vocab import FeatureVocab
    return FeatureVocab.from_names(f"f{i}" for i in range(n_features))


def stacked_tails(trainer):
    """The two sorted tail streams of a trainer's flat problem: the
    row-sorted Xv stream (segments = B*R rows) and the column-sorted X'v
    stream (segments = B*n columns)."""
    prob = trainer.prob
    return {"xv_rows": (prob.tail_rows, prob.y.shape[0]),
            "xtv_cols": (prob.tail_c_cols, prob.prior_mean.shape[0])}


def check_and_time(name, seg, S, L, dtype, gen, results):
    """Kernel vs plain version at one shape; appends a result row."""
    import torch
    from mlease_tpu_torch.ops.segment_sum import (min_bytes,
                                                  segment_sum_sorted,
                                                  segment_sum_sorted_reference)
    T = seg.numel()
    contrib = torch.randn((L, T), generator=gen, device="cuda", dtype=dtype)
    got = segment_sum_sorted(contrib, seg, S)
    ref64 = segment_sum_sorted_reference(contrib.double(), seg, S)
    scale = segment_sum_sorted_reference(contrib.double().abs(), seg, S)
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    ok = bool((err <= tol * scale).all())
    lib_out = torch.zeros((L, S), dtype=dtype, device="cuda")
    dname = str(dtype).replace("torch.", "")
    # least time: the bytes it must move, or one add per entry and lane
    bytes_ms = min_bytes(L, T, S, contrib.element_size()) / HBM_BYTES_PER_S
    ops_ms = L * T / PEAK_OPS[dname]
    row = {
        "shape": name, "L": L, "T": T, "S": S, "dtype": dname,
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
        "ok": ok,
        "kernel_ms": cuda_ms(lambda: segment_sum_sorted(contrib, seg, S)),
        "plain_ms": cuda_ms(
            lambda: segment_sum_sorted_reference(contrib, seg, S)),
        "library_ms": cuda_ms(lambda: lib_out.index_add_(1, seg, contrib)),
        "bound_ms": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print("kernel-check " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        raise AssertionError(f"segment_sum_sorted disagrees at {name} "
                             f"L={L} {dtype}: max err {row['max_abs_err']}")
    return row


def kernel_phase(trainers, args):
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = []
    for tag, trainer in trainers.items():
        for stream, (seg, S) in stacked_tails(trainer).items():
            for L, dtype in ((3, torch.float32), (6, torch.float32),
                             (3, torch.float64)):
                check_and_time(f"{tag}/{stream}", seg, S, L, dtype, gen,
                               results)
    # edge streams: most segments empty; one segment holding everything
    rng = np.random.default_rng(args.seed)
    sparse = np.sort(rng.choice(np.arange(0, 1_000_000, 97), 300_000))
    edge = {"edge/empty_segments": (sparse, 1_000_000),
            "edge/one_segment": (np.full(2_000_000, 12_345), 20_000)}
    for name, (ids, S) in edge.items():
        seg = torch.as_tensor(ids.astype(np.int32), device="cuda")
        for L, dtype in ((3, torch.float32), (6, torch.float64)):
            check_and_time(name, seg, S, L, dtype, gen, results)
    empty = torch.ones(1_000_000, dtype=torch.bool, device="cuda")
    empty[torch.as_tensor(sparse, device="cuda")] = False
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    seg = torch.as_tensor(sparse.astype(np.int32), device="cuda")
    out = segment_sum_sorted(torch.randn((3, seg.numel()), generator=gen,
                                         device="cuda"), seg, 1_000_000)
    if bool((out[:, empty] != 0).any()):
        raise AssertionError("empty segments are not exactly 0")
    return results


def cli_phase():
    import numpy as np
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.utils.config import JobConfig

    data = os.path.join(REPO, "examples", "data", "breast-cancer")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        props = dict(JobConfig.from_file(data + ".job"))
        out = os.path.join(tmp, "out")
        props.update({"input.paths": os.path.join(data, "train"),
                      "test.path": os.path.join(data, "test"),
                      "output.base.path": out, "head.size": "16",
                      "dtype": "float64"})
        job = os.path.join(tmp, "breast-cancer.job")
        with open(job, "w") as f:
            f.writelines(f"{k}={v}\n" for k, v in props.items())
        env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "mlease_tpu_torch", "train", job],
            capture_output=True, text=True, env=env, cwd=REPO,
            timeout=CLI_TIMEOUT_S)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI train failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        for rel in ("final-model/part-r-00000.avro",
                    "lambda-rho/part-r-00000.avro", "model-vocab.json",
                    "test/lambda-1.0/_loglik/part-r-00000.avro",
                    f"best-model/best-iteration-{summary['iterations']}.avro"):
            if not os.path.exists(os.path.join(out, rel)):
                raise AssertionError(f"CLI output lacks {rel}")
        ll_dir = os.path.join(out, "sample-test-loglik")
        lls = [r["testLoglik"] for f in sorted(os.listdir(ll_dir))
               for r in avro.read_records(os.path.join(ll_dir, f))]
        test_ll = [r["testLoglik"] for lam in summary["models"]
                   for r in avro.read_records(os.path.join(
                       out, "test", f"lambda-{lam}", "_loglik"))]
        if not lls or not np.all(np.isfinite(lls + test_ll)):
            raise AssertionError("non-finite or missing logliks")
        launches = summary["kernel_launches"]["segment_sum_sorted"]
        if launches <= 0:
            raise AssertionError("the CLI run never launched the kernel")
    row = {"iterations": summary["iterations"], "wall_s": wall,
           "solver_wall_s": summary["wall_time_s"],
           "sample_logliks": len(lls), "test_logliks": test_ll,
           "kernel_launches": launches}
    print("cli " + json.dumps(row), flush=True)
    return row


def full_width_phase(trainer, args):
    import numpy as np
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.ops.segment_sum import (segment_sum_sorted,
                                                  segment_sum_sorted_reference)

    z_first = {}

    def keep_first(iteration, z, **_kw):
        if iteration == 1:
            z_first["z"] = z.clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segment_sum_sorted.launches = 0          # main path: count from here
    res = trainer.run(callback=keep_first)
    torch.cuda.synchronize()
    launches = segment_sum_sorted.launches   # ... to here
    peak = torch.cuda.max_memory_allocated()
    nt = sum(s["newton_trips"] for s in res.solver_stats)
    cg = sum(s["cg_trips"] for s in res.solver_stats)
    expected = 2 * cg + 2 * nt + 3 * len(res.solver_stats)
    row = {"rows": int(trainer.data.nrows.sum()), "dim": trainer.dim,
           "tail_entries": int(trainer.prob.tail_vals.numel()),
           "iterations": res.iterations, "iter_s": res.iter_times,
           "solver_stats": res.solver_stats, "kernel_launches": launches,
           "expected_launches": expected,
           "max_memory_allocated_bytes": int(peak),
           "z_finite": bool(np.isfinite(res.z).all())}
    if launches == 0 or launches != expected or not row["z_finite"]:
        raise AssertionError(f"full-width run: {row}")

    # the first iteration again, every sorted-tail reduce on the plain version
    trainer.config = dataclasses.replace(trainer.config, num_iters=1)
    with mock.patch.object(tm, "segment_sum_sorted",
                           segment_sum_sorted_reference):
        plain = trainer.run()
    zk = z_first["z"].double().cpu().numpy()
    diff = float(np.abs(zk - plain.z).max())
    row["z_kernel_vs_plain_max_abs"] = diff
    row["z_max_abs"] = float(np.abs(zk).max())
    row["plain_iter_s"] = plain.iter_times
    row["plain_solver_stats"] = plain.solver_stats
    print("full-width " + json.dumps(row), flush=True)
    if not diff <= 1e-4 * row["z_max_abs"]:
        raise AssertionError(f"kernel and plain first iterations differ: "
                             f"{diff} vs max|z| {row['z_max_abs']}")
    return row


def device_time(fn):
    """Run fn() under torch.profiler: its host wall time and the device
    time by kernel (copies included). None when the profiler records no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_kernel = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue              # host events; device kernels and copies stay
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            by_kernel.append((ev.key, dev_us / 1e3, ev.count))
    if not by_kernel:
        return None
    by_kernel.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    seg = [r for r in by_kernel if "segment_sum_sorted_kernel" in r[0]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "segment_sum_kernel_ms": sum(r[1] for r in seg),
            "segment_sum_kernel_count": sum(r[2] for r in seg),
            "top": [{"name": k[:100], "ms": ms, "count": c}
                    for k, ms, c in by_kernel[:15]]}


def speed_phase(trainers, args):
    """ADMM iterations/s at each shape: --iters timed iterations, then one
    ADMM step (no host transfers of z and u) under the profiler for the
    device's busy share and the time by kernel."""
    import torch

    device_time(lambda: torch.ones(1, device="cuda") + 1)  # profiler warm-up
    rows = {}
    for tag, trainer in trainers.items():
        trainer.config = dataclasses.replace(trainer.config,
                                             num_iters=args.iters)
        res = trainer.run()
        steady = res.iter_times[1:] or res.iter_times
        row = {"iter_s": res.iter_times, "solver_stats": res.solver_stats,
               "steady_iter_s": sum(steady) / len(steady),
               "iterations_per_s": len(steady) / sum(steady)}
        # the first iteration's step from z = u = 0, as run() takes it
        L, n, B = len(trainer.lambdas), trainer.dim, trainer.nblocks
        cfg, dev = trainer.config, trainer.device
        z = torch.zeros((L, n), dtype=cfg.dtype, device=dev)
        u = torch.zeros((L, B, n), dtype=cfg.dtype, device=dev)
        rho = torch.as_tensor(trainer.rhos, dtype=cfg.dtype, device=dev)
        eps = cfg.liblinear_epsilon * trainer.eps_scale
        stats = {}

        def one_step():
            stats.update(trainer.step(trainer.prob, trainer.present, z, u,
                                      trainer.lam_vec, rho, rho, eps)[3])
        one_step()                                    # warm
        row["profiled_step"] = device_time(one_step)
        row["profiled_step_stats"] = stats
        print(f"speed {tag} " + json.dumps(row), flush=True)
        rows[tag] = row
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-per-block", type=int, default=1_562_500,
                    help="full-width rows per block (8 blocks; the default"
                         " is ctr-12m.job's 12.5M rows, uncut)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="",
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "mlease_tpu_torch", "csrc")):
        return fail("run from a checkout of the repository: "
                    "mlease_tpu_torch/ is missing beside chip_smoke.py")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs a CUDA device")
    sys.path.insert(0, REPO)
    from mlease_tpu_torch.device import resolve_device
    from mlease_tpu_torch.ops import segment_sum
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    report = {"phases": {}, "failed": []}
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    resolve_device("cuda")

    def phase(name, fn, *a):
        t0 = time.monotonic()
        try:
            out = fn(*a)
            report["phases"][name] = {
                "ok": True, "s": time.monotonic() - t0,
                "result": out if name != "setup" else None}
            return out
        except Exception:
            traceback.print_exc()
            report["phases"][name] = {"ok": False,
                                      "s": time.monotonic() - t0}
            report["failed"].append(name)
            return None

    def build():
        t0 = time.monotonic()
        path = segment_sum.build(verbose=True)
        row = {"library": os.path.relpath(path, REPO),
               "build_s": time.monotonic() - t0}
        print("build " + json.dumps(row), flush=True)
        return row

    phase("build", build)

    def setup():
        trainers = {}
        # bench.py's default step: 4 x 16,384 rows, 50K features, 15 nnz,
        # head 512; then ctr-12m.job's widths, 8 x --rows-per-block rows
        for tag, (nf, B, R, nnz, head) in (
                ("bench", (50_000, 4, 16_384, 15, 512)),
                ("full", (1_000_000, 8, args.rows_per_block, 12, 128))):
            t0 = time.monotonic()
            cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                             head_size=head, pcg=True, flat_blocks=True,
                             dtype=torch.float32)
            trainers[tag] = tr = AdmmTrainer(
                synth_blocked_data(nf, B, R, nnz, args.seed),
                make_vocab(nf), cfg)
            torch.cuda.synchronize()
            print(f"{tag} setup: {B * R} rows, {tr.dim} columns, head {head},"
                  f" {tr.prob.tail_vals.numel()} tail entries, "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        print(f"full-width rows: {8 * args.rows_per_block} (ctr-12m.job has "
              f"12.5M)", flush=True)
        return trainers

    trainers = None
    if not report["failed"]:
        trainers = phase("setup", setup)
    if trainers is not None:
        kernels = phase("kernel", kernel_phase, trainers, args)
        phase("cli", cli_phase)
        full = phase("full_width", full_width_phase, trainers["full"], args)
        phase("speed", speed_phase, trainers, args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(report, card=card), f, indent=1)
    if report["failed"]:
        return fail(f"failed phases: {report['failed']}")

    main_row = next(r for r in kernels
                    if r["shape"] == "full/xtv_cols" and r["L"] == 3
                    and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "segment_sum_sorted", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/segment_sum.cu",
        "replaces": "mlease_tpu/ops/pallas/tile_sum.py:72",
        "launches": full["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
