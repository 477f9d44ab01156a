#!/usr/bin/env python3
"""Run one cell several times, one process a run, and print each run's
result and every metric's spread: how the bounds of BENCHMARK.json are
measured.

    python3 gpubench/spread.py --workload <name> --seeds 11,12,13
        [--sets 2] [--seconds S] [--trace 0] [--out DIR]

Each set runs the seeds in order (the same seeds in every set). The
spread of a metric in a set is the distance between the first and third
quartile (`statistics.quantiles(values, n=4)`) as a share of the median;
a bound is set to about five times the widest spread over the sets and
the cells. --out keeps each run's standard output and error there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sets: list[list[dict]] = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, cwd=ROOT, timeout=1500)
            wall = time.monotonic() - t0
            if args.out:
                stem = os.path.join(args.out, f"{args.workload}.set{k}."
                                    f"{seed}.t{args.trace}")
                with open(stem + ".out", "w") as f:
                    f.write(proc.stdout)
                with open(stem + ".err", "w") as f:
                    f.write(proc.stderr)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(json.dumps({"set": k, "seed": seed, "rc":
                                  proc.returncode, "wall_s": wall,
                                  "stderr": proc.stderr[-2000:]}),
                      flush=True)
                continue
            res = json.loads(lines[-1])
            row = {"set": k, "seed": seed, "wall_s": wall,
                   "correct": res["correct"],
                   "compared": res["compared"],
                   "metrics": {m: v["value"]
                               for m, v in res["metrics"].items()},
                   "device": res["device"]}
            print(json.dumps(row), flush=True)
            runs.append(row)
        sets.append(runs)
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        per_set = []
        for runs in sets:
            vals = [r["metrics"][name] for r in runs if name in r["metrics"]]
            if len(vals) >= 2:
                per_set.append({"median": statistics.median(vals),
                                "spread": spread(vals), "n": len(vals)})
        print(json.dumps({"metric": name, "sets": per_set}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
