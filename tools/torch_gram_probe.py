#!/usr/bin/env python3
"""What bounds the weighted-Gram kernel's tensor-core variant, measured on
the card (one H100; needs nvcc):

    python3 tools/torch_gram_probe.py [--out FILE.jsonl]

1. the rates of the mma.sync instructions themselves
   (tools/torch_mma_sync_rates.cu): the ceiling of a kernel that feeds the
   tensor cores from registers;
2. at R = 131,072, F = 512 (one problem), float32 and bf16-in, the "mma"
   variant of mlease_tpu_torch/csrc/gram_mma_{f32,bf16}.cu as shipped and
   rebuilt with its ablation switches: GRAM_ABLATE_LOADS_ONLY (the cp.async
   ring alone, no multiply: what the staged re-reads of X cost) and, for
   float32, GRAM_ABLATE_NO_FLUSH (the three products accumulated in the
   tensor core itself instead of flushed every k-step: faster, and wrong
   beyond the tolerance, which is why the kernel flushes); each with its
   time and its largest error relative to sum_r |d x_i x_j| against a
   float64 product.

Prints one JSON object per measurement, the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch
    from mlease_tpu_torch.ops import _build, gram

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    rows = []

    def say(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    say({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]})

    def cuda_ms(fn, reps=20):
        for _ in range(3):
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

    with tempfile.TemporaryDirectory(prefix="gram-probe-") as tmp:
        builds = {"rates": subprocess.Popen(
            [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-o", os.path.join(tmp, "mma_rates"),
             os.path.join(REPO, "tools", "torch_mma_sync_rates.cu")])}
        variants = [("f32", "shipped", []),
                    ("f32", "loads_only", ["-DGRAM_ABLATE_LOADS_ONLY"]),
                    ("f32", "no_flush", ["-DGRAM_ABLATE_NO_FLUSH"]),
                    ("bf16", "shipped", []),
                    ("bf16", "loads_only", ["-DGRAM_ABLATE_LOADS_ONLY"])]
        for name, tag, flags in variants:
            lib = os.path.join(tmp, f"lib_{name}_{tag}.so")
            builds[name, tag] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib,
                 str(_build.CSRC / f"gram_mma_{name}.cu")])
        for key, proc in builds.items():
            if proc.wait() != 0:
                print(f"nvcc failed on {key}", file=sys.stderr)
                return 1
        for line in subprocess.run(
                [os.path.join(tmp, "mma_rates")], capture_output=True,
                text=True, check=True).stdout.splitlines():
            say(json.loads(line))

        R, F = 131_072, 512
        for name, tag, _flags in variants:
            dtype = torch.float32 if name == "f32" else torch.bfloat16
            gen = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn((R, F), generator=gen, device="cuda").to(dtype)
            d = torch.rand((1, R), generator=gen, device="cuda").to(dtype)
            x64, d64 = x.double(), d[0].double()
            ref = (x64.T * d64) @ x64
            scale = (x64.abs().T * d64) @ x64.abs()
            del x64
            fn = getattr(ctypes.CDLL(os.path.join(
                tmp, f"lib_{name}_{tag}.so")), f"gram_mma_{name}")
            fn.argtypes = gram._ARGTYPES["mma"]
            fn.restype = ctypes.c_int
            cfg = gram.launch_config(1, R, F, dtype)
            dk = d.float()
            out = torch.empty((1, F, F), device="cuda")
            ws = torch.empty((1, cfg.nsplit, F, F), device="cuda")

            def call():
                return fn(x.data_ptr(), dk.data_ptr(), None, out.data_ptr(),
                          ws.data_ptr(), 1, R, F, R * F, cfg.tile, 1,
                          cfg.nsplit,
                          torch.cuda.current_stream().cuda_stream)

            if call() != 0:
                print(f"launch failed: {name} {tag}", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            err = float(((out[0].double() - ref).abs() / scale).max())
            say({"R": R, "F": F, "dtype": name, "build": tag,
                 "tile": cfg.tile, "row_splits": cfg.nsplit,
                 "kernel_ms": cuda_ms(call),
                 "max_rel_err": None if tag == "loads_only" else err})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
