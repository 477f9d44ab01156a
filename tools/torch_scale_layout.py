#!/usr/bin/env python3
"""The streaming trainer at the scale jobs' own layouts on one card:
examples/data/ctr-25m.job (16 blocks of 1,562,500 rows, 8 groups, head 128
stored as bfloat16, a 4 GB pin budget) and ctr-100m.job (32 blocks of
3,125,000 rows, 16 groups, 10 GB), each at its own row count.

    python3 tools/torch_scale_layout.py [--layout ctr-25m --layout ...]
                                        [--iters 3] [--seed 0]
                                        [--out FILE.jsonl]

The data is chip_smoke.py's threaded generator at the jobs' widths
(1,000,001 columns, 12 nonzeros a row on zipf 1.3, the intercept), made
group by group (synth_blocked_data's `blocks`) and split into the job's
groups with the job's head (core/dataset.py::to_hybrid, column-sorted
tails, as the train pipeline converts a streamed group), not read from
Avro: decoding and packing 100M rows would take about 50 minutes (the job
headers). Then StreamingAdmmTrainer with the job's lambdas, epsilon,
liblinear.epsilon, head and pin budget (consensus, wire and tail padding
"auto", as the job leaves them), --iters of the job's 5 iterations.

Each layout runs in a process of its own (so that its peak RSS and device
memory are its own) and prints one JSON line: the machine's host RAM
(`free -g`) and the process's peak RSS, the rows made and any cut of them
(rows are cut only where the host's available memory could not hold the
run: `cuts`), the host bytes page-locked,
the device bytes the trainer holds after its set-up, residency_report(),
s an iteration, trips, wire bytes an iteration, the pass-floor
decomposition (utils/floor.py: util against the composed floor), the
device's peak allocated and reserved bytes over the run, and the card's
name and power limit; --out appends the lines to a file too. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the jobs' layouts (examples/data/ctr-25m.job, ctr-100m.job)
LAYOUTS = {"ctr-25m": dict(blocks=16, rows=25_000_000, groups=8,
                           budget_gb=4.0),
           "ctr-100m": dict(blocks=32, rows=100_000_000, groups=16,
                            budget_gb=10.0)}
FEATURES, NNZ, HEAD = 1_000_000, 12, 128
# the process's peak host bytes: HOST_BASE_BYTES and HOST_BYTES_PER_ROW a
# row (the groups, each freed once the trainer has page-locked its copy),
# fitted to two runs of this script on an H100 host with 101 GB: peak RSS
# 22.4 GB at ctr-25m's 25M rows, 55.6 GB at ctr-100m's 100M; rows are cut
# where the estimate passes HOST_SHARE of the memory available
HOST_BYTES_PER_ROW = 442
HOST_BASE_BYTES = 11_400_000_000
HOST_SHARE = 0.95


def available_bytes() -> int:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) * 1024


def make_groups(layout, rows_per_block, seed):
    """The layout's groups, each made and converted on a thread of its
    own (4 at a time), in block order."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import chip_smoke
    from mlease_tpu_torch.core.dataset import to_hybrid

    B, G = layout["blocks"], layout["groups"]
    per = B // G

    def group(g):
        ell = chip_smoke.synth_blocked_data(
            FEATURES, B, rows_per_block, NNZ, seed,
            blocks=(g * per, (g + 1) * per))
        return to_hybrid(ell, HEAD, column_sorted=True,
                         head_dtype=torch.bfloat16)
    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(group, range(G)))


def run_layout(name, iters, seed) -> dict:
    import torch
    import chip_smoke
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.pipeline import _hand_over
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    from mlease_tpu_torch.utils.config import JobConfig
    from mlease_tpu_torch.utils.floor import (measure_put_bandwidth,
                                              streaming_floor)

    layout = LAYOUTS[name]
    job = JobConfig.from_file(os.path.join(REPO, "examples", "data",
                                           f"{name}.job"))
    B = job.get_int("num.blocks")
    G = job.get_int("streaming.groups")
    budget = job.get_float("streaming.resident.head.gb", 8.0)
    if (B, G, budget) != (layout["blocks"], layout["groups"],
                          layout["budget_gb"]):
        raise AssertionError(f"{name}.job: {B} blocks, {G} groups, "
                             f"{budget} GB; expected {layout}")
    rows_per_block = layout["rows"] // B
    cuts = []
    room = available_bytes()
    if HOST_BASE_BYTES + layout["rows"] * HOST_BYTES_PER_ROW \
            > HOST_SHARE * room:
        cut = int((HOST_SHARE * room - HOST_BASE_BYTES)
                  / HOST_BYTES_PER_ROW) // B
        cuts.append(f"rows per block {rows_per_block} -> {cut}: "
                    f"{room / 2**30:.1f} GiB available")
        rows_per_block = cut
    cfg = AdmmConfig(
        lambdas=[float(v) for v in job.get_string("lambda").split(",")],
        num_iters=iters, regularizer=job.get_int("regularizer"),
        epsilon=job.get_float("epsilon"),
        liblinear_epsilon=job.get_float("liblinear.epsilon"),
        head_size=job.get_int("head.size"), head_dtype=torch.bfloat16,
        pcg=True, flat_blocks=True, dtype=torch.float32)
    t0 = time.monotonic()
    groups = make_groups(layout, rows_per_block, seed)
    make_s = time.monotonic() - t0
    vocab = chip_smoke.make_vocab(FEATURES)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    # as the train pipeline builds it: the trainer gets the only
    # reference to each group and frees it once it is page-locked
    tr = StreamingAdmmTrainer(_hand_over(groups), vocab, cfg,
                              resident_head_budget_gb=budget)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    res = tr.run()
    torch.cuda.synchronize()
    steady = chip_smoke.steady_s(res.iter_times)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout
    return {
        "layout": name, "card": chip_smoke.card_line(),
        "rows": rows_per_block * B, "blocks": B, "groups": G,
        "rows_per_block": rows_per_block, "cuts": cuts,
        "budget_gb": budget, "lambdas": cfg.lambdas,
        "epsilon": cfg.epsilon, "liblinear_epsilon": cfg.liblinear_epsilon,
        "make_s": make_s, "build_s": build_s,
        "host_ram_free_g": free.strip().splitlines(),
        "peak_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "pinned_host_bytes": tr._held_bytes()["page_locked_bytes"],
        "device_bytes_after_setup": int(held),
        "residency": tr.residency_report(),
        "wire_bytes_per_iter": tr.stream_wire_bytes(),
        "iterations": res.iterations, "iter_s": res.iter_times,
        "steady_iter_s": steady, "solver_stats": res.solver_stats,
        "pass_floor": streaming_floor(
            tr.groups, tr.trip_log, tr.stream_wire_bytes(), steady,
            measure_put_bandwidth(), len(cfg.lambdas), dtype=cfg.dtype),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "max_memory_reserved_bytes": int(torch.cuda.max_memory_reserved()),
        "z_finite": bool(__import__("numpy").isfinite(res.z).all())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", action="append", choices=sorted(LAYOUTS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(run_layout(args.one, args.iters, args.seed)),
              flush=True)
        return 0
    failed = []
    for name in args.layout or sorted(LAYOUTS):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", name,
             "--iters", str(args.iters), "--seed", str(args.seed)],
            capture_output=True, text=True, cwd=REPO, timeout=1800)
        line = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode != 0 or not line.startswith("{"):
            print(f"{name} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
            failed.append(name)
            continue
        row = dict(json.loads(line), wall_s=time.monotonic() - t0)
        print(json.dumps(row), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        if not row["z_finite"]:
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
