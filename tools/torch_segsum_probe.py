#!/usr/bin/env python3
"""What the sorted-stream segment-sum kernel (K1) costs at the ADMM main
path's widths, measured on the card (one H100; needs nvcc):

    python3 tools/torch_segsum_probe.py [--seed 0] [--out FILE.jsonl]

Builds mlease_tpu_torch/csrc/segment_sum.cu as shipped and with its
switches: SEGSUM_VEC (entries a lane takes in a step of 32 * SEGSUM_VEC;
8 shipped), SEGSUM_DEPTH (the steps of a warp's stream in flight or ready
in its shared-memory ring; 2 shipped) and the ablation
SEGSUM_ABLATE_NO_STORE (runs summed, nothing written to out: what the
output writes cost). Times each build with CUDA events on synthetic
streams shaped like the full-width (ctr-12m) trainer's:

- contrib form, L 3, float32: T 29,709,312 entries over S 8,000,008 sorted
  zipf-1.3 column ids (the column stream), and the same T over 12,500,000
  uniformly drawn row ids (the row stream);
- gather form, L 3, float32, into an accumulator: the column stream
  gathering V (3, 12.5M) by uniform row ids (`_xtv_lm`), from V lanes-major
  and from a lanes-minor view, and the row stream gathering V (3, 8M) by
  zipf column ids (`_xv_lm`).

Beside them: the zero fill of the contrib form's (3, 8M) output, a copy of
the column stream's bytes (what the card streams at best), and one call
at T = 1,000 (the wrapper's host time). Prints one JSON object per
measurement, the card's name and power limit first; each build's registers
and spills from -Xptxas -v.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VARIANTS = [("shipped", []),
            ("vec4", ["-DSEGSUM_VEC=4"]),
            ("depth3", ["-DSEGSUM_DEPTH=3"]),
            ("no_store", ["-DSEGSUM_ABLATE_NO_STORE"])]


def main() -> int:
    import numpy as np
    import torch
    from mlease_tpu_torch.ops import _build
    from mlease_tpu_torch.ops.segment_sum import segment_sum_gather

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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

    dev = "cuda"
    rng = np.random.default_rng(args.seed)
    T, S_col, S_row, L = 29_709_312, 8_000_008, 12_500_000, 3
    col = torch.as_tensor(np.sort((rng.zipf(1.3, T) - 1) % S_col)
                          .astype(np.int32), device=dev)
    row = torch.sort(torch.randint(0, S_row, (T,), dtype=torch.int32,
                                   device=dev)).values
    row_ids = torch.randint(0, S_row, (T,), dtype=torch.int32, device=dev)
    col_ids = torch.as_tensor(((rng.zipf(1.3, T) - 1) % S_col)
                              .astype(np.int32), device=dev)
    vals = torch.randn(T, device=dev)
    contrib = torch.randn((L, T), device=dev)
    V_rows = torch.randn((L, S_row), device=dev)
    V_cols = torch.randn((L, S_col), device=dev)
    acc_col = torch.randn((L, S_col), device=dev)
    acc_row = torch.randn((L, S_row), device=dev)

    say({"what": "zero fill (3, 8M) float32",
         "ms": cuda_ms(lambda: torch.zeros((L, S_col), device=dev))})
    say({"what": "copy of the column stream's bytes (contrib + seg)",
         "bytes": L * T * 4 + 4 * T,
         "ms": cuda_ms(lambda: (contrib.clone(), col.clone()))})
    small = torch.zeros(1000, dtype=torch.int32, device=dev)
    small_v = torch.randn(1000, device=dev)
    small_out = torch.zeros((L, 10), device=dev)
    segment_sum_gather(small_v, V_rows, small, small, 10, out=small_out)
    say({"what": "one gather call at T = 1,000 (host time per call)",
         "ms": cuda_ms(lambda: segment_sum_gather(
             small_v, V_rows, small, small, 10, out=small_out), reps=200)})

    cases = {
        "contrib/column_stream": (contrib, None, None, col, S_col, None),
        "contrib/row_stream": (contrib, None, None, row, S_row, None),
        "gather/xtv": (vals, V_rows, row_ids, col, S_col, acc_col),
        "gather/xv": (vals, V_cols, col_ids, row, S_row, acc_row),
        "gather/xtv_lanes_minor": (vals, V_rows.t().contiguous().t(),
                                   row_ids, col, S_col, acc_col),
    }
    with tempfile.TemporaryDirectory(prefix="segsum-probe-") as tmp:
        procs = {}
        for name, flags in VARIANTS:
            lib = os.path.join(tmp, f"lib{name}.so")
            procs[name] = (lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                 "-o", lib, str(_build.CSRC / "segment_sum.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, flags in VARIANTS:
            lib_path, proc = procs[name]
            log, _ = proc.communicate()
            if proc.returncode != 0:
                say({"variant": name, "build_failed": log[-2000:]})
                continue
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = [int(b) for b in
                      re.findall(r"(\d+) bytes spill stores", log)]
            lib = ctypes.CDLL(lib_path)
            fn = lib.segment_sum_f32
            ll, vp = ctypes.c_longlong, ctypes.c_void_p
            fn.argtypes = [vp, ll, vp, ll, ll, vp, vp, vp, ll, ll, ll, ll,
                           ctypes.c_int, vp, ll, vp]
            fn.restype = ctypes.c_int
            lib.segment_sum_workspace_bytes.argtypes = [ll, ll, ll, ll,
                                                        ctypes.c_int]
            lib.segment_sum_workspace_bytes.restype = ll
            out = {"variant": name, "flags": flags,
                   "registers": [min(regs), max(regs)] if regs else None,
                   "max_spill_bytes": max(spills) if spills else None}
            for case, (v, V, idx, seg, S, acc) in cases.items():
                ws = torch.empty(max(lib.segment_sum_workspace_bytes(
                    T, L, 4, 4, int(V is not None)), 1), dtype=torch.uint8,
                    device=dev)
                dst = torch.zeros((L, S), device=dev) if acc is None else acc

                def call():
                    err = fn(v.data_ptr(), v.stride(0) if V is None else 0,
                             None if V is None else V.data_ptr(),
                             0 if V is None else V.stride(0),
                             0 if V is None else V.stride(1),
                             None if idx is None else idx.data_ptr(),
                             seg.data_ptr(), dst.data_ptr(), L, T, S, L,
                             int(acc is not None), ws.data_ptr(),
                             ws.numel(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {case}: CUDA error {err}")
                # contrib form: the kernel alone, into a zero-filled output
                out[case + "_ms"] = cuda_ms(call)
            say(out)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
