#!/usr/bin/env python3
"""The control of a bfloat16 cell's comparison (ctr12m.bf16): the plain
reference put in the program's place one precision below what the
configuration states, bfloat16: float8 (e4m3, 3 mantissa bits), judged by
the same number against the float64 reference on the same data. It is
gpubench/control.py's TF32 control with the operands rounded to e4m3
instead: every data product's operands (the head, the tail values, the
coefficient and row vectors) rounded to the nearest e4m3 value, saturated
at its largest finite value (448) as an fp8 tensor-core GEMM does, and
summed in float32.

    python3 gpubench/control_fp8.py --workload <name> --seed <n> [--seed ...]

prints one JSON line a seed: the control's z_gap, its gap in each lambda
lane, the cell's limit, and the trips of both. The benchmark's own runs
never run it. A control should come out as not correct (z_gap above the
limit) on every seed; against ctr12m.bf16's one limit this one does not,
since the lambda 1 lane decides both readings, while its lambda 10 and
100 lanes read far above the program's (PERF.md section 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
E4M3_MAX = 448.0


def fp8_precision():
    """reference.Precision with a "fp8" precision beside its two."""
    import torch
    from gpubench import reference

    class Precision(reference.Precision):
        def __init__(self, name: str):
            if name != "fp8":
                super().__init__(name)
                return
            self.name, self.dtype = name, torch.float32

        def operand(self, t):
            if self.name != "fp8":
                return super().operand(t)
            t = t.to(torch.float32).clamp(-E4M3_MAX, E4M3_MAX)
            return t.to(torch.float8_e4m3fn).to(torch.float32)

    return Precision


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
    plain = reference.Precision
    reference.Precision = fp8_precision()
    try:
        t0 = time.monotonic()
        ctl = reference.run(spec, seed, job, dev, precision="fp8")
    finally:
        reference.Precision = plain
    zc, zr = ctl.z.numpy(), ref.z.numpy()
    return {"workload": workload, "seed": seed, "precision": "fp8_e4m3",
            "z_gap": z_gap(zc, zr),
            "z_gap_by_lambda": [z_gap(a[None], b[None])
                                for a, b in zip(zc, zr)],
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
