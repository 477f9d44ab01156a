#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (mlease_tpu_torch) on one H100.

    python3 chip_smoke.py [--seed 0] [--rows-per-block 1562500] [--iters 3]
                          [--out FILE.json] [--gram-only]

Phases, each of which fails the run when it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the port's kernels (mlease_tpu_torch/csrc/segment_sum.cu, gram.cu
     and gram_mma_{f32,bf16,f64}.cu) with nvcc from the sources in this
     checkout, one nvcc process per source, started together;
  3. kernel phase K1: `segment_sum_sorted` against its plain version on the
     card, at the main path's tail streams (the bench-default shape and the
     full-width shape of phase 6), float32 with L=3 and L=6 lanes and
     float64, the item CLI phase's record stream (2 prefixes, float64, 9,600
     records), plus empty segments and one giant segment; per segment
     |kernel - ref64| <= 1e-5 * sum|contrib| (float32), 1e-12 (float64);
     times from CUDA events over >= 20 repeats;
  4. kernel phase K2: `gram_batched` against a float64 reference at the
     per-item bucket shapes (B = 20,000; R 64, F 16 in float32 and float64;
     R 256, F 64), the head-block shapes (3 lanes sharing X (1,562,500,
     128), and phase 10's X (16,384, 512)), the TPU kernel's documented
     shape (R = 131,072, F = 512 in
     float32, bf16-in and float64; F = 256) and edge shapes (ragged R, rows
     that are no 16-byte multiple, R = 1, F = 8, rows with d = 0); per entry
     |G - G64| <= 1e-5 * sum_r|d x_i x_j| (float32 and bf16-in, the
     reference taken from the rounded inputs), 1e-12 (float64), G == G'
     exactly, and a second call that gives the same bits; every row names
     the kernel variant and the arithmetic that ran (ops/gram.py::
     launch_config); times as for K1, the library call being `torch.bmm` of the scaled transpose with TF32 off (for a
     shared X one `torch.matmul` that contracts the rows, or one product
     per lane, whichever is faster: `library_call` names it);
  5. CLI phase: `python -m mlease_tpu_torch train` on a copy of
     examples/data/breast-cancer.job (float64, head.size=16), output in a
     temporary directory; checks the output layout, finite logliks and
     that the kernel was launched;
  6. full-width phase (the ADMM main path): AdmmTrainer at the widths of
     examples/data/ctr-12m.job (1,000,001 columns, 12 nnz/row on zipf 1.3,
     head.size=128, 8 blocks, lambda 1/10/100, float32, Jacobi PCG, flat
     blocks) on synthetic data made from --seed, 8 x --rows-per-block rows
     (by default ctr-12m.job's 12.5M, uncut; --rows-per-block 250000 for
     a quicker run); K1's launch count is read from exactly this run; then the
     first iteration again with the plain reduce,
     max|z_kernel - z_plain| <= 1e-4 * max|z|;
  7. speed phase: ADMM iterations/s at bench.py's default shape (4 x 16,384
     rows, 50K features, 15 nnz, head 512) and at the full width, and one
     ADMM step of each under torch.profiler (device busy share, time by
     kernel);
  8. item phase (the per-item main path, at its full size): 10,000 items x
     48 rows x 12 features (the generator of bench.py's item mode, from
     --seed), 1 x 2 grid, full posterior covariance, Cholesky route,
     float32, through `train_item_models_columnar`; K2's launch count is
     read from exactly this run and must equal the Newton trips plus one
     covariance pass per bucket; then the same run with K2 patched to its
     plain version (coefficients to 1e-4 * max|w|, variances to 1e-3
     relative), the TRON route on 1,000 items against the Cholesky route
     (5e-3 * max|w|: float32 bounds both routes at about 1e-3),
     cold and steady models/s and one run under torch.profiler;
  9. item CLI phase: 200 items written as Avro, then `python -m
     mlease_tpu_torch item` and `itemtest` on the card; checks the outputs,
     finite testLoglik and both kernels' launch counts;
 10. head-block phase: `tron_multi(precondition="head_block")` on one block
     of the bench shape (16,384 rows, head 512) against
     precondition="jacobi": the same W to 1e-3 * max|W|, no more CG trips,
     K2 launched once per Newton trip plus one, and the head block that
     `build_head_precond` factorises against K2's plain version on the
     same weights (a preconditioner does not move the solution, so the
     solve alone could not fail a wrong Gram).

The line before the last is the card's name and power limit, the one before
it the `kernels` line; the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. --gram-only builds the kernels, runs phase 4
alone and stops there, without the closing lines (for work on K2).
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
# peak rates (H100 SXM data sheet), FLOP/s: float32 and float64 outside the
# tensor cores, bfloat16 dense on them
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
# ... and for a matrix product of the type's accuracy, which may go through
# the tensor cores: float32 as three TF32 products (495 / 3 = 165 TFLOP/s,
# above the 67 outside them), float64 as DMMA (67), bfloat16 as above
GRAM_PEAK_OPS = {"float32": 495e12 / 3, "float64": 67e12,
                 "bfloat16": 989e12}
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
        # the same work as the kernel's call: zero fill, then one index_add_
        "library_ms": cuda_ms(
            lambda: lib_out.zero_().index_add_(1, seg, contrib)),
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
    # the record stream that the item CLI phase's `itemtest` reduces: one
    # entry per nonzero of its 200 x 48 records, 2 model prefixes, float64
    nnz = np.diff(item_cli_rows(args).row_start)
    seg = torch.as_tensor(np.repeat(np.arange(len(nnz)), nnz)
                          .astype(np.int32), device="cuda")
    check_and_time("item_cli/records", seg, len(nnz), 2, torch.float64, gen,
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


# K2 shapes: (name, B, R, F, dtype name, shared X)
GRAM_SHAPES = [
    ("item/R64_F16", 20_000, 64, 16, "float32", False),
    ("item/R64_F16", 20_000, 64, 16, "float64", False),
    ("item/R256_F64", 20_000, 256, 64, "float32", False),
    ("head_block/ctr-12m", 3, 1_562_500, 128, "float32", True),
    ("head_block/bench", 3, 16_384, 512, "float32", True),   # phase 10's
    ("tpu_doc/F512", 1, 131_072, 512, "float32", False),
    ("tpu_doc/F512", 1, 131_072, 512, "bfloat16", False),
    ("tpu_doc/F512", 1, 131_072, 512, "float64", False),
    ("tpu_doc/F256", 1, 131_072, 256, "float32", False),
    ("edge/ragged_R", 2, 4_099, 200, "float32", False),
    ("edge/ragged_R", 2, 4_099, 200, "float64", True),
    ("edge/ragged_F", 1, 50_001, 130, "float32", False),   # 520-byte rows
    ("edge/ragged_F", 40, 300, 13, "bfloat16", False),      # the FMA kernel
    ("edge/R1_F8", 7, 1, 8, "float32", False),
    ("edge/F8", 1_000, 37, 8, "bfloat16", False),
]
ITEM_K2_ROW = ("item/R64_F16", "float32")   # the item phase's one bucket


def gram_check_and_time(name, B, R, F, dname, shared, gen, results):
    """K2 against a float64 reference at one shape; appends a result row."""
    import torch
    from mlease_tpu_torch.ops import gram

    dtype = getattr(torch, dname)
    acc = gram.accumulate_dtype(dtype)
    x = torch.randn((R, F) if shared else (B, R, F), generator=gen,
                    device="cuda").to(dtype)
    d = torch.rand((B, R), generator=gen, device="cuda").to(dtype)
    d[:, ::5] = 0                                   # rows with d = 0
    pvi = torch.rand((B, F), generator=gen, device="cuda").to(acc) + 0.5
    got = gram.gram_batched(x, d, pvi)
    # float64 reference from the (rounded) inputs; entry by entry for the
    # few long problems, whose batched float64 einsum would not fit
    def weighted_gram(xs, ds):
        if B > 4:
            return gram.gram_batched_reference(xs, ds)
        return torch.stack([((xs if shared else xs[b]).T * ds[b])
                            @ (xs if shared else xs[b]) for b in range(B)])

    x64, d64 = x.to(torch.float64, copy=True), d.double()   # abs_'d below
    ref64 = weighted_gram(x64, d64) + torch.diag_embed(pvi.double())
    scale = weighted_gram(x64.abs_(), d64)          # d >= 0
    del x64, d64
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    symmetric = bool((got == got.transpose(1, 2)).all())
    same_bits = bool((got == gram.gram_batched(x, d, pvi)).all())
    ok = bool((err <= tol * scale + 1e-300).all()) and symmetric \
        and same_bits
    bytes_ms = gram.min_bytes(B, R, F, x.element_size(), got.element_size(),
                              shared) / HBM_BYTES_PER_S
    ops_ms = gram.min_flops(B, R, F) / GRAM_PEAK_OPS[dname]
    cfg = gram.launch_config(B, R, F, dtype, shared, x.data_ptr() % 16 == 0)
    row = {"shape": name, "B": B, "R": R, "F": F, "dtype": dname,
           "shared_x": shared, "variant": cfg.variant,
           "route": gram.route(cfg.variant, dtype), "tile": cfg.tile,
           "row_splits": cfg.nsplit, "lanes": cfg.lanes,
           "ops_rate_tflops": GRAM_PEAK_OPS[dname] / 1e12,
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
           "symmetric": symmetric, "same_bits_again": same_bits, "ok": ok,
           "bound_ms": max(bytes_ms, ops_ms) * 1e3,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    del ref64, scale, err
    if ok:
        row["kernel_ms"] = cuda_ms(lambda: gram.gram_batched(x, d, pvi))
        row["plain_ms"] = cuda_ms(
            lambda: gram.gram_batched_reference(x, d, pvi))
        # PyTorch's own product for the same function (no diagonal), TF32
        # off. A shared X is not expanded into a batch (bmm's long-K path
        # is slow there): one matmul that contracts the rows, or one
        # product per lane; the faster of the two is the yardstick
        if shared:
            calls = {
                "matmul": lambda: torch.matmul(x.T * d[:, None, :], x),
                "mm per lane": lambda: [(x.T * d[b]) @ x for b in range(B)]}
        else:
            calls = {"bmm": lambda: torch.bmm(
                x.transpose(1, 2) * d[:, None, :], x)}
        timed = {k: cuda_ms(fn) for k, fn in calls.items()}
        row["library_call"] = min(timed, key=timed.get)
        row["library_ms"] = timed[row["library_call"]]
        row["library_calls_ms"] = timed
    print("kernel-check K2 " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        raise AssertionError(f"gram_batched disagrees at {name} {dname}: "
                             f"max err {row['max_abs_err']}, symmetric "
                             f"{symmetric}, same bits again {same_bits}")
    return row


def gram_phase(args):
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the library yardstick")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = []
    for shape in GRAM_SHAPES:
        gram_check_and_time(*shape, gen, results)
        torch.cuda.empty_cache()
    return results


def synth_item_decoded(n_items, rows_per_item, n_feat, seed):
    """Columnar per-item rows, the generator of the JAX package's bench.py
    item mode: 2-6 features a row drawn without replacement, a logistic
    response from per-item true coefficients."""
    import numpy as np
    from mlease_tpu_torch.train.item import DecodedRows

    rng = np.random.default_rng(seed)
    N = n_items * rows_per_item
    item_of_row = np.repeat(np.arange(n_items), rows_per_item)
    nnz = rng.integers(2, 7, size=N)
    order = np.argsort(rng.random((N, n_feat)), axis=1)
    lane = np.arange(n_feat)[None, :] < nnz[:, None]
    feat_id = order[lane].astype(np.int32)
    vals = rng.normal(size=len(feat_id)).astype(np.float32)
    row_start = np.zeros(N + 1, np.int64)
    np.cumsum(nnz, out=row_start[1:])
    w_true = (rng.normal(size=(n_items, n_feat)) * 0.5).astype(np.float32)
    score = np.zeros(N, np.float64)
    np.add.at(score, np.repeat(np.arange(N), nnz),
              w_true[np.repeat(item_of_row, nnz), feat_id] * vals)
    p = 1.0 / (1.0 + np.exp(-(score - 0.4)))
    response = (rng.random(N) < p).astype(np.int32)
    return DecodedRows(
        response=response, weight=np.ones(N, np.float32),
        offset=np.zeros(N, np.float32), row_start=row_start,
        feat_id=feat_id, feat_val=vals,
        vocab_names=[f"f{j}" for j in range(n_feat)],
        keys=[f"item{i}" for i in item_of_row])


def max_model_diff(a, b):
    """(max |coefficient difference|, max |coefficient|) over two model
    dictionaries with equal keys."""
    diff = scale = 0.0
    for key, m in a.items():
        o = b[key]
        diff = max(diff, abs(m.intercept - o.intercept))
        scale = max(scale, abs(m.intercept))
        for name, v in m.coefficients.items():
            diff = max(diff, abs(v - o.coefficients[name]))
            scale = max(scale, abs(v))
    return diff, scale


def item_phase(args):
    import math
    import torch
    import mlease_tpu_torch.ops.newton as newton_mod
    import mlease_tpu_torch.ops.objective as objective_mod
    from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference
    from mlease_tpu_torch.train import item

    n_items, rows_per_item, n_feat = 10_000, 48, 12
    t0 = time.monotonic()
    decoded = synth_item_decoded(n_items, rows_per_item, n_feat, args.seed)
    datagen_s = time.monotonic() - t0
    cfg = item.ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                          compute_var=True, full_cov=True, solver="cholesky",
                          dtype=torch.float32)

    def run():
        t0 = time.monotonic()
        res = item.train_item_models_columnar(decoded, cfg, device="cuda")
        torch.cuda.synchronize()
        return res, time.monotonic() - t0

    gram_batched.launches = 0                # main path: count from here
    res, cold_s = run()
    launches = gram_batched.launches         # ... to here
    expected = sum(s["newton_trips"] + 1 for s in res.solver_stats)
    n_models = len(res.models)
    finite = all(
        math.isfinite(m.intercept)
        and all(math.isfinite(v) for v in m.coefficients.values())
        for m in res.models.values())
    var_pos = all(
        v.intercept > 0 and all(math.isfinite(x) and x > 0
                                for x in v.coefficients.values())
        for v in res.posterior_var.values())
    row = {"items": n_items, "rows_per_item": rows_per_item,
           "features": n_feat, "models": n_models, "datagen_s": datagen_s,
           "buckets": res.solver_stats, "kernel_launches": launches,
           "expected_launches": expected, "finite": finite,
           "variances_positive": var_pos, "cold_s": cold_s,
           "cold_models_per_s": n_models / cold_s}
    if (n_models != 2 * n_items or not finite or not var_pos or launches == 0
            or launches != expected
            or len(res.covariances) != n_models):
        raise AssertionError(f"item run: {row}")

    _res2, steady_s = run()
    row["steady_s"] = steady_s
    row["steady_models_per_s"] = n_models / steady_s
    t0 = time.monotonic()
    packed = item.pack_buckets_columnar(decoded, cfg)
    row["pack_s"] = time.monotonic() - t0
    del packed
    prof = device_time(lambda: item.train_item_models_columnar(
        decoded, cfg, device="cuda"))
    row["profiled_run"] = prof

    # the same run with K2 on its plain version
    with mock.patch.object(newton_mod, "gram_batched",
                           gram_batched_reference), \
            mock.patch.object(objective_mod, "gram_batched",
                              gram_batched_reference):
        before = gram_batched.launches
        plain, plain_s = run()
        if gram_batched.launches != before:
            raise AssertionError("the plain run launched the kernel")
    row["plain_s"] = plain_s
    diff, scale = max_model_diff(res.models, plain.models)
    row["w_kernel_vs_plain_max_abs"], row["w_max_abs"] = diff, scale
    var_rel = 0.0
    for key, v in res.posterior_var.items():
        o = plain.posterior_var[key]
        var_rel = max(var_rel, abs(v.intercept - o.intercept) / o.intercept,
                      *(abs(x - o.coefficients[n]) / o.coefficients[n]
                        for n, x in v.coefficients.items()))
    row["var_kernel_vs_plain_max_rel"] = var_rel
    if not diff <= 1e-4 * scale or not var_rel <= 1e-3:
        raise AssertionError(f"kernel and plain item runs differ: {row}")

    # the TRON route on 1,000 items against the Cholesky route, both solved
    # to a tight tolerance. In float32 either route stops once a step no
    # longer lowers f by more than float32 resolves (~1e-7 * f), which
    # leaves each ~1e-3 from the float64 solution: hence 5e-3 * max|w|
    small = synth_item_decoded(1_000, rows_per_item, n_feat, args.seed + 1)
    tight = dataclasses.replace(cfg, full_cov=False, liblinear_epsilon=1e-6)
    chol = item.train_item_models_columnar(small, tight, device="cuda")
    tron = item.train_item_models_columnar(
        small, dataclasses.replace(tight, solver="tron"), device="cuda")
    diff, scale = max_model_diff(chol.models, tron.models)
    row["tron_vs_cholesky_max_abs"], row["tron_w_max_abs"] = diff, scale
    row["tron_buckets"] = tron.solver_stats
    print("item " + json.dumps(row), flush=True)
    if not diff <= 5e-3 * scale:
        raise AssertionError(f"TRON and Cholesky routes differ: {diff} vs "
                             f"max|w| {scale}")
    return row


def item_cli_rows(args):
    """The item CLI phase's rows: 200 items x 48 rows x 12 features."""
    return synth_item_decoded(200, 48, 12, args.seed + 2)


def item_cli_phase(args):
    import numpy as np
    from mlease_tpu_torch.io import avro

    decoded = item_cli_rows(args)
    feature = {"type": "record", "name": "feature", "fields": [
        {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
        {"name": "value", "type": "float"}]}
    schema = {"type": "record", "name": "ItemRow", "fields": [
        {"name": "item", "type": "string"}, {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": feature}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"}]}
    rs = decoded.row_start
    records = [{
        "item": decoded.keys[i], "response": int(decoded.response[i]),
        "features": [{"name": decoded.vocab_names[f], "term": "",
                      "value": float(v)}
                     for f, v in zip(decoded.feat_id[rs[i]:rs[i + 1]],
                                     decoded.feat_val[rs[i]:rs[i + 1]])],
        "weight": 1.0, "offset": 0.0} for i in range(len(decoded.response))]
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-item-") as tmp:
        data = os.path.join(tmp, "items.avro")
        avro.write_records(data, schema, records)
        models = os.path.join(tmp, "models")
        out = os.path.join(tmp, "itest")
        jobs = {
            "item": {"input.paths": data, "item.key": "item",
                     "intercept.lambdas": "1", "default.lambdas": "1,10",
                     "compute.var": "true", "output.model.path": models},
            "itemtest": {"input.paths": data, "item.key": "item",
                         "model.path": os.path.join(models,
                                                    "part-r-00000.avro"),
                         "output.base.path": out}}
        summaries, walls = {}, {}
        for cmd, props in jobs.items():
            job = os.path.join(tmp, cmd + ".job")
            with open(job, "w") as f:
                f.writelines(f"{k}={v}\n" for k, v in props.items())
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "mlease_tpu_torch", cmd, job],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=CLI_TIMEOUT_S)
            walls[cmd] = time.monotonic() - t0
            if proc.returncode != 0:
                raise AssertionError(f"CLI {cmd} failed ({proc.returncode}):"
                                     f"\n{proc.stderr[-3000:]}")
            summaries[cmd] = json.loads(proc.stdout.strip().splitlines()[-1])
        for path in (os.path.join(models, "part-r-00000.avro"),
                     os.path.join(out, "pred", "part-r-00000.avro"),
                     os.path.join(out, "_loglik", "part-r-00000.avro")):
            if not os.path.exists(path):
                raise AssertionError(f"item CLI output lacks {path}")
        logliks = [r["testLoglik"] for r in avro.read_records(
            os.path.join(out, "_loglik"))]
        n_pred = len(avro.read_records(os.path.join(out, "pred")))
    row = {"models": summaries["item"]["models"], "scored": n_pred,
           "test_logliks": logliks, "wall_s": walls,
           "item_kernel_launches": summaries["item"]["kernel_launches"],
           "itemtest_kernel_launches":
               summaries["itemtest"]["kernel_launches"]}
    print("item-cli " + json.dumps(row), flush=True)
    if (row["models"] != 400 or n_pred != len(records) or len(logliks) != 2
            or not np.all(np.isfinite(logliks))
            or row["item_kernel_launches"]["gram_batched"] <= 0
            or row["itemtest_kernel_launches"]["segment_sum_sorted"] <= 0):
        raise AssertionError(f"item CLI run: {row}")
    return row


def head_block_phase(args):
    """tron_multi with the head-block preconditioner against Jacobi, on one
    block of bench.py's default shape."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import to_hybrid
    from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference

    R, nf, nnz, H = 16_384, 50_000, 15, 512
    data = to_hybrid(synth_blocked_data(nf, 1, R, nnz, args.seed + 3), H)
    n, lams = data.dim, [1.0, 10.0, 100.0]

    def t(a, dtype=None):
        return torch.as_tensor(a, device="cuda", dtype=dtype)

    f32 = torch.float32
    head = (t(data.head, f32), t(data.head_ids), t(data.tail_rows),
            t(data.tail_cols), t(data.tail_vals, f32), t(data.tail_c_rows),
            t(data.tail_c_cols), t(data.tail_c_vals, f32))
    prob = tm.stack_blocks(
        t(data.indices), t(data.values, f32), t(data.y, f32),
        t(data.weight, f32), t(data.offset, f32), head,
        torch.zeros((len(lams), 1, n), dtype=f32, device="cuda"),
        t(lams, f32))
    prob = prob._replace(head_x=prob.head_x[0])      # one block, non-flat
    W0 = torch.zeros((n, len(lams)), dtype=f32, device="cuda")
    eps = 1e-4
    # every head block that build_head_precond factorises during one solve,
    # against K2's plain version on the same weights
    diffs, scales, a_shapes = [], [], set()

    def checked_gram(x, d, pvi=None):
        got = gram_batched(x, d, pvi)
        ref = gram_batched_reference(x, d, pvi)
        diffs.append(float((got - ref).abs().max()))
        scales.append(float(ref.abs().max()))
        a_shapes.add((tuple(x.shape), tuple(got.shape)))
        return got

    with mock.patch.object(tm, "gram_batched", checked_gram):
        tm.tron_multi(prob, W0, eps, precondition="head_block")
    a_diff, a_scale = max(diffs), max(scales)
    out = {}
    for kind in ("jacobi", "head_block"):
        tm.tron_multi(prob, W0, eps, precondition=kind)          # warm
        torch.cuda.synchronize()
        gram_batched.launches = 0
        t0 = time.monotonic()
        res = tm.tron_multi(prob, W0, eps, precondition=kind)
        torch.cuda.synchronize()
        out[kind] = (res, time.monotonic() - t0, gram_batched.launches)
    jac, blk = out["jacobi"][0], out["head_block"][0]
    diff = float((blk.w - jac.w).abs().max())
    scale = float(jac.w.abs().max())
    row = {"rows": R, "dim": n, "head": H, "lambdas": lams, "eps": eps,
           "w_max_abs_diff": diff, "w_max_abs": scale,
           "head_block_kernel_vs_plain_max_abs": a_diff,
           "head_block_max_abs": a_scale,
           "converged": [bool(jac.converged.all()),
                         bool(blk.converged.all())],
           "jacobi": {"newton_trips": jac.newton_trips,
                      "cg_trips": jac.cg_trips, "s": out["jacobi"][1],
                      "gram_launches": out["jacobi"][2]},
           "head_block": {"newton_trips": blk.newton_trips,
                          "cg_trips": blk.cg_trips, "s": out["head_block"][1],
                          "gram_launches": out["head_block"][2]}}
    print("head-block " + json.dumps(row), flush=True)
    if (not bool(torch.isfinite(blk.w).all()) or not diff <= 1e-3 * scale
            or blk.cg_trips > jac.cg_trips
            or a_shapes != {((R, H), (len(lams), H, H))}
            or not a_diff <= 1e-5 * a_scale
            or out["head_block"][2] != blk.newton_trips + 1
            or out["jacobi"][2] != 0):
        raise AssertionError(f"head-block solve: {row}")
    return row


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
    gram = [r for r in by_kernel if any(
        k in r[0] for k in ("gram_item_kernel", "gram_mma_kernel",
                            "gram_tile_kernel", "gram_reduce_kernel"))]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "segment_sum_kernel_ms": sum(r[1] for r in seg),
            "segment_sum_kernel_count": sum(r[2] for r in seg),
            "gram_kernel_ms": sum(r[1] for r in gram),
            "gram_kernel_count": sum(r[2] for r in gram),
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
    ap.add_argument("--gram-only", action="store_true",
                    help="build, run the K2 kernel phase alone and stop")
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
    from mlease_tpu_torch.ops import _build, gram, segment_sum
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
        paths = _build.build_many([segment_sum.SOURCE, *gram.SOURCES],
                                  verbose=True)
        row = {"libraries": [os.path.relpath(p, REPO) for p in paths],
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

    if args.gram_only:
        if not report["failed"]:
            phase("kernel_gram", gram_phase, args)
        print(card_line(), flush=True)
        return fail(f"failed phases: {report['failed']}") \
            if report["failed"] else 0

    trainers = None
    if not report["failed"]:
        trainers = phase("setup", setup)
    if trainers is not None:
        kernels = phase("kernel", kernel_phase, trainers, args)
        grams = phase("kernel_gram", gram_phase, args)
        phase("cli", cli_phase)
        full = phase("full_width", full_width_phase, trainers["full"], args)
        phase("speed", speed_phase, trainers, args)
        del trainers
        torch.cuda.empty_cache()
        items = phase("item", item_phase, args)
        phase("item_cli", item_cli_phase, args)
        phase("head_block", head_block_phase, args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(report, card=card), f, indent=1)
    if report["failed"]:
        return fail(f"failed phases: {report['failed']}")

    main_row = next(r for r in kernels
                    if r["shape"] == "full/xtv_cols" and r["L"] == 3
                    and r["dtype"] == "float32")
    gram_row = next(r for r in grams
                    if (r["shape"], r["dtype"]) == ITEM_K2_ROW)
    print(json.dumps({"kernels": [{
        "name": "segment_sum_sorted", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/segment_sum.cu",
        "replaces": "mlease_tpu/ops/pallas/tile_sum.py:79",
        "launches": full["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "gram_batched", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/gram.cu",
        "replaces": "mlease_tpu/ops/pallas/gram.py:77",
        "launches": items["kernel_launches"],
        "max_abs_err": gram_row["max_abs_err"],
        "ms": gram_row["kernel_ms"], "plain_ms": gram_row["plain_ms"],
        "bound_ms": gram_row["bound_ms"], "bound_by": gram_row["bound_by"],
        "library_ms": gram_row["library_ms"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
