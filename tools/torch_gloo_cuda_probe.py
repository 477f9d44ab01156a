#!/usr/bin/env python3
"""Whether gloo's collectives take CUDA tensors as they are, and what that
costs against copying them to the host first, on two ranks that share one
card (the mesh phase of chip_smoke.py runs so):

    python3 tools/torch_gloo_cuda_probe.py [--reps 20] [--out FILE.json]

Starts two processes of itself over a file:// store, one card. Each
measurement runs a collective two ways on the same CUDA tensor:

- direct: dist.all_reduce / dist.all_gather on the CUDA tensor;
- staged: the tensor copied to host memory, the collective there, the
  result copied back.

The shapes are the mesh paths' at ctr-12m widths (L 3 lambdas, n 1,000,001
features, float32): the consensus sums (2, L, n) and the trip maxima (2,)
int64 of every ADMM iteration, the feature-sharded diffs (L,), the u
gather (L, 4, n) per rank, and the item covariances (2, 5,000, 16, 16)
per rank. For each it checks that both ways give the same bits on every
rank and reports the median host time of a call (synchronised on both
sides, both ranks at a barrier first). Prints one JSON object per
measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

L, N = 3, 1_000_001


def cases(torch):
    f32 = dict(dtype=torch.float32, device="cuda")
    return [
        ("consensus_sums", "all_reduce", "sum", lambda g: torch.randn(
            (2, L, N), generator=g, **f32)),
        ("trip_max", "all_reduce", "max", lambda g: torch.randint(
            0, 100, (2,), generator=g, dtype=torch.int64, device="cuda")),
        ("fs_diffs", "all_reduce", "max", lambda g: torch.rand(
            (L,), generator=g, **f32)),
        ("u_gather", "all_gather", None, lambda g: torch.randn(
            (L, 4, N), generator=g, **f32)),
        ("item_cov_gather", "all_gather", None, lambda g: torch.randn(
            (2, 5000, 16, 16), generator=g, **f32)),
    ]


def rank_main(rank: int, init: str, reps: int, out: str) -> int:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=2, rank=rank)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000 + rank)
    rows = []
    for name, kind, op, make in cases(torch):
        src = make(gen)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}.get(op)

        def direct():
            if kind == "all_reduce":
                t = src.clone()
                dist.all_reduce(t, op=rop)
                return t
            parts = [torch.empty_like(src) for _ in range(2)]
            dist.all_gather(parts, src)
            return torch.cat(parts)

        def staged():
            h = src.to("cpu", copy=True)
            if kind == "all_reduce":
                dist.all_reduce(h, op=rop)
                return h.to("cuda")
            parts = [torch.empty_like(h) for _ in range(2)]
            dist.all_gather(parts, h)
            return torch.cat(parts).to("cuda")

        row = {"name": name, "collective": kind, "op": op,
               "shape": list(src.shape), "dtype": str(src.dtype),
               "bytes": src.numel() * src.element_size()}
        got = {}
        for way, fn in (("direct", direct), ("staged", staged)):
            try:
                res = fn()
                torch.cuda.synchronize()
            except Exception as e:          # the finding, not a fault
                row[f"{way}_error"] = f"{type(e).__name__}: {e}"[:300]
                continue
            got[way] = res
            times = []
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[f"{way}_ms"] = 1e3 * statistics.median(times)
            row[f"{way}_sha1"] = hashlib.sha1(
                res.cpu().numpy().tobytes()).hexdigest()
        row["same_bits"] = (len(got) == 2
                            and bool(torch.equal(got["direct"],
                                                 got["staged"])))
        rows.append(row)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.rank is not None:
        return rank_main(args.rank, args.init, args.reps, args.dir)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory(prefix="gloo-cuda-probe-") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--init", os.path.join(tmp, "pg"), "--dir", tmp,
             "--reps", str(args.reps)]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            print(f"ranks failed: {rcs}", file=sys.stderr)
            return 1
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(2)]
    rows = []
    for r0, r1 in zip(*ranks):
        row = dict(r0, card=card,
                   ranks_same_bits=all(r0.get(f"{w}_sha1") == r1.get(
                       f"{w}_sha1") for w in ("direct", "staged")),
                   rank1_direct_ms=r1.get("direct_ms"),
                   rank1_staged_ms=r1.get("staged_ms"))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
