#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed one precision below
what the configuration states (float32 with TF32 off: TF32), judged by
the same number against the float64 reference on the same data.

    python3 gpubench/control.py --workload <name> --seed <n> [--seed ...]

prints one JSON line a seed: the control's z_gap, the cell's limit, and
the trips of both. The benchmark's own runs never run it; the control has
to come out as not correct (z_gap above the limit) on every seed.
gpubench/tests/test_gpubench_control.py runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_gap(workload: str, seed: int, *, root: str = ROOT,
                device: str = "cuda") -> dict:
    import torch
    from gpubench import datagen, reference
    from gpubench.run import load_cell, z_gap

    c = load_cell(root, workload)
    spec = datagen.DataSpec.from_config(c["config"]["data"])
    job = reference.Job.from_keys(c["job"])
    dev = torch.device(device)
    t0 = time.monotonic()
    ref = reference.run(spec, seed, job, dev)
    ref_s = time.monotonic() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ctl = reference.run(spec, seed, job, dev, precision="tf32")
    return {"workload": workload, "seed": seed,
            "z_gap": z_gap(ctl.z.numpy(), ref.z.numpy()),
            "limit": float(c["limits"]["z_gap"]),
            "reference_s": ref_s, "control_s": time.monotonic() - t0,
            "reference_trips": ref.trips, "control_trips": ctl.trips}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("gpubench control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        print(json.dumps(control_gap(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
