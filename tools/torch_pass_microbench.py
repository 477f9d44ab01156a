#!/usr/bin/env python3
"""Per-pass device times of the port's flat-blocks solver: the tables that
mlease_tpu_torch/utils/floor.py composes a streamed iteration's floor from.

    python3 tools/torch_pass_microbench.py --floors [--shape bench|12m|both]
                                           [--dtype float32|bfloat16]
                                           [--out-dir tools] [--seed 0]

On one CUDA card. Each pass (ops/tron_multi.py: `_xv_lm` "xv", `_xtv_lm`
"xtv", `_xtv_and_sqdiag_lm` "fused_xtv_diag", `_hv_lm` "hv" and
`_fun_grad_curvature_lm(with_diag=True)` "fun_grad_diag") is captured as a
CUDA graph and replayed, timed with CUDA events over --reps replays, less
the time of a graph that holds one tiny kernel ("null_loop_ms"): the
pass's device time without the host's launch cost, as the JAX package's
tools/pass_microbench.py --floors measures its passes inside one jitted
loop. The problem is the flat-blocks stack of AdmmTrainer (`trainer.prob`)
on synthetic data (chip_smoke.py's generator, from --seed), in the compute
dtype --dtype (float32 by default), 3 lambdas, random lanes-major vectors:

  bench  bench.py's default step: 4 blocks x 16,384 rows, 50,000 features,
         15 nnz a row, head 512 -> tools/torch_pass_floors.json
  12m    one group of examples/data/ctr-12m.job as it streams: 2 blocks x
         1,562,500 rows, 1,000,000 features, 12 nnz a row, head 128 stored
         as bfloat16 -> tools/torch_pass_floors_12m.json

Each table holds the JAX tables' keys (chip, platform, layout, shape,
floors_ms, null_loop_ms, loop_trips) with "platform": "cuda", "chip" and
"power_limit" from nvidia-smi, and the head's storage dtype. --dtype
bfloat16 (the head stored as bfloat16 too) writes the same tables with
"dtype": "bfloat16" under names ending in _bf16, the only tables a
bfloat16 run's floor takes (utils/floor.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {
    "bench": dict(features=50_000, blocks=4, rows=16_384, nnz=15, head=512,
                  head_dtype="float32", out="torch_pass_floors.json"),
    "12m": dict(features=1_000_000, blocks=2, rows=1_562_500, nnz=12,
                head=128, head_dtype="bfloat16",
                out="torch_pass_floors_12m.json"),
}
LAMBDAS = 3


def card():
    """(name, power limit) as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return name, power


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call of `fn`, captured as a CUDA graph and replayed
    `reps` times between two CUDA events."""
    import torch
    fn()                                   # builds, warms the libraries
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    for _ in range(3):
        g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(tag: str, seed: int, reps: int, dtype: str = "float32") -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import make_vocab, synth_blocked_data
    from mlease_tpu_torch.ops import tron_multi as tm
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    s = SHAPES[tag]
    bf16 = dtype == "bfloat16"
    head_name = "bfloat16" if bf16 else s["head_dtype"]
    dt = getattr(torch, dtype)
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], head_size=s["head"],
                     head_dtype=getattr(torch, head_name), pcg=True,
                     flat_blocks=True, dtype=dt)
    data = synth_blocked_data(s["features"], s["blocks"], s["rows"],
                              s["nnz"], seed)
    trainer = AdmmTrainer(data, make_vocab(s["features"]), cfg)
    B, n, L = s["blocks"], trainer.dim, LAMBDAS
    dev = trainer.device
    prob = tm.lanes_major(tm.with_prior(
        trainer.prob, torch.zeros((L, B, n), device=dev),
        torch.ones(L, device=dev)))
    R = prob.y.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = (torch.randn((L, B * n), generator=gen, device=dev) * 0.1).to(dt)
    C = torch.randn((L, R), generator=gen, device=dev).to(dt)
    Dm = (torch.rand((L, R), generator=gen, device=dev) * 0.25).to(dt)
    tiny = torch.zeros((), device=dev)
    null = graph_ms(lambda: tiny.add_(1e-30), reps)
    passes = {
        "xv": lambda: tm._xv_lm(prob, W),
        "xtv": lambda: tm._xtv_lm(prob, C),
        "fused_xtv_diag": lambda: tm._xtv_and_sqdiag_lm(prob, C, Dm),
        "hv": lambda: tm._hv_lm(prob, Dm, W),
        "fun_grad_diag": lambda: tm._fun_grad_curvature_lm(
            prob, W, with_diag=True, blocks=1),
    }
    floors = {k: round(max(graph_ms(f, reps) - null, 0.0), 4)
              for k, f in passes.items()}
    name, power = card()
    ell_k = int(trainer.data.indices.shape[2])
    return {
        "chip": name, "power_limit": power, "platform": "cuda",
        "layout": "flat-blocks", "head_dtype": head_name,
        **({"dtype": dtype} if bf16 else {}),
        "shape": {"features": s["features"], "blocks": B, "rows": s["rows"],
                  "nnz": s["nnz"], "lambdas": L, "head": s["head"],
                  "tail_nnz_per_block": int(
                      np.asarray(trainer.data.tail_rows).shape[1]),
                  "ell_k": ell_k},
        "floors_ms": floors,
        "null_loop_ms": round(null, 4),
        "loop_trips": reps,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--floors", action="store_true",
                    help="measure the per-pass tables and write them")
    ap.add_argument("--shape", choices=("bench", "12m", "both"),
                    default="both")
    ap.add_argument("--out-dir", default=os.path.join(REPO, "tools"))
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the compute dtype")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not args.floors:
        ap.error("nothing to do: pass --floors")
    import torch
    if not torch.cuda.is_available():
        print("torch_pass_microbench: needs a CUDA card", file=sys.stderr)
        return 1
    for tag in (("bench", "12m") if args.shape == "both" else (args.shape,)):
        tab = measure(tag, args.seed, args.reps, args.dtype)
        out = SHAPES[tag]["out"]
        if args.dtype == "bfloat16":
            out = out.replace(".json", "_bf16.json")
        path = os.path.join(args.out_dir, out)
        with open(path, "w") as f:
            json.dump(tab, f, indent=1)
            f.write("\n")
        print(f"{os.path.relpath(path, REPO)}: {json.dumps(tab)}",
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
