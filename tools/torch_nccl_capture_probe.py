#!/usr/bin/env python3
"""What an NCCL all_reduce leaves in a captured CUDA graph, on a one-rank
process group on one card (AdmmTrainer.run_fused captures the mesh's
collectives into the branches of its device loop, whose conditional bodies
may hold only kernel, memcpy, memset, empty, child-graph and conditional
nodes):

    python3 tools/torch_nccl_capture_probe.py [--out FILE.json]

For each of the two collectives of a mesh iteration at ctr-12m widths (the
(2, L, n) float32 consensus sums, L 3, n 1,000,001, and the (2,) int64 trip
maxima), and for both torch capture modes ("global" and "thread_local"): a
warm eager call, then the call captured into a torch.cuda.CUDAGraph
(keep_graph=True); the graph's node types counted, child graphs included
(csrc/device_loop.cu's device_loop_node_types), the graph replayed and its
result checked against the eager call's. Then the capture wrapped as a
branch of a one-branch ops/device_loop.py loop, which must build and run.
Prints the card's name and power limit, then one JSON object per case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import ctypes

    import torch
    import torch.distributed as dist

    from mlease_tpu_torch.collectives import all_reduce
    from mlease_tpu_torch.ops import device_loop
    from mlease_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    distributed.initialize_single("cuda")
    lib = device_loop._load()
    rows = []
    try:
        for what, make, op in (
                ("consensus_sums", lambda: torch.ones(
                    (2, 3, 1_000_001), device="cuda"), "sum"),
                ("trip_max", lambda: torch.tensor(
                    [5, 7], dtype=torch.int64, device="cuda"), "max")):
            for mode in ("global", "thread_local"):
                row = {"collective": what, "capture_mode": mode,
                       "backend": dist.get_backend()}
                t = make()
                want = all_reduce(t.clone(), op)
                torch.cuda.synchronize()
                try:
                    g = torch.cuda.CUDAGraph(keep_graph=True)
                    with torch.cuda.graph(g, capture_error_mode=mode):
                        all_reduce(t, op)
                    n = len(device_loop.NODE_TYPES)
                    counts = (ctypes.c_int * n)()
                    err = lib.device_loop_node_types(
                        ctypes.c_void_p(g.raw_cuda_graph()), counts, n)
                    row["node_types"] = {k: c for k, c in zip(
                        device_loop.NODE_TYPES, counts) if c}
                    row["node_types_err"] = err
                    t.copy_(make())
                    g.replay()
                    torch.cuda.synchronize()
                    row["replay_equal"] = bool(torch.equal(t, want))
                except Exception as e:          # the finding, recorded
                    row["error"] = f"{type(e).__name__}: {e}"
                    traceback.print_exc()
                rows.append(row)
                print(json.dumps(row), flush=True)
        # a one-branch device loop around a captured all_reduce
        t = torch.ones(4, device="cuda")
        phase = torch.zeros((), dtype=torch.int32, device="cuda")
        k = torch.zeros((), dtype=torch.int64, device="cuda")

        def branch():
            all_reduce(t, "sum")
            k.add_(1)
            phase.copy_(torch.where(k < 5, 1, 0))
        loop = device_loop.DeviceLoop([(1, "reduce", branch)], phase,
                                      [t, k],
                                      kernels={"all_reduce": all_reduce})
        row = {"case": "device_loop"}
        try:
            loop.prepare()
            phase.fill_(1)
            loop.run()
            torch.cuda.synchronize()
            c = loop.counts()
            row.update(k=int(k), t=t.tolist(), counts=c)
        except Exception as e:
            row["error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        finally:
            loop.close()
        rows.append(row)
        print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
