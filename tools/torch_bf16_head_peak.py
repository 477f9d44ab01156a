#!/usr/bin/env python3
"""Peak device memory and s/iteration of the in-memory ADMM trainer at
ctr-12m.job's widths with the dense head stored as bfloat16.

    python3 tools/torch_bf16_head_peak.py [--tree DIR] [--rows-per-block N]
                                          [--iters 2] [--seed 0]

Builds chip_smoke.py's full-width data (1,000,001 columns, 12 nnz/row on
zipf 1.3, 8 blocks of --rows-per-block rows, head 128), trains --iters
iterations of AdmmTrainer (λ 1/10/100, float32, Jacobi PCG, flat blocks)
with head_dtype=bfloat16 and prints one JSON line: the peak of
torch.cuda.max_memory_allocated over the run, the iteration times, and a
checksum of z. --tree imports mlease_tpu_torch from another checkout (an
unpacked `git archive` of an earlier commit), so two versions of the
solver's head passes can be compared in one call on one card. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--rows-per-block", type=int, default=1_562_500)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    nf = 1_000_000
    data = chip_smoke.synth_blocked_data(nf, 8, args.rows_per_block, 12,
                                         args.seed)
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                     head_size=128, head_dtype=torch.bfloat16, pcg=True,
                     flat_blocks=True, dtype=torch.float32)
    tr = AdmmTrainer(data, chip_smoke.make_vocab(nf), cfg)
    del data
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = tr.run()
    torch.cuda.synchronize()
    print(json.dumps({
        "tree": os.path.relpath(os.path.abspath(args.tree), REPO),
        "rows": 8 * args.rows_per_block, "head_dtype": "bfloat16",
        "resident_bytes_before_run": int(resident),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "iter_s": res.iter_times, "run_s": time.monotonic() - t0,
        "solver_stats": res.solver_stats,
        "z_abs_sum": float(abs(res.z).sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
