#!/usr/bin/env python3
"""One run of one cell of the benchmark of `mlease_tpu_torch`.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout. The cell is the `workloads` entry of
BENCHMARK.json with that name; its configuration (gpubench/configs/
<config>.json: the job's keys and the data's shape), its traffic mix
(gpubench/traffic/<traffic>.json: the job keys it sets or removes), the
limits of its comparison (gpubench/limits/<workload>.json) and each metric
(gpubench/metrics/<metric>.py, a `read(run)` of the run's record) are
found by name, so a new cell, configuration, mix or metric is new files.

A run: makes the data on the card from the seed (gpubench/datagen.py),
hands it to the program on the host and builds the trainer as the train
pipeline does (`admm_config_from_job`; `AdmmTrainer`, or `split_blocks`
and the pipeline's `_streaming_trainer` for a streamed job), runs one
whole lambda path to warm up (the device loops are captured there and the
kernels built once into the checkout's mlease_tpu_torch/_build/), then
runs whole paths from z = 0 for `--seconds`: the window is the first
timed path's start to the end of the last path begun before the time ran
out. Once it has closed it reads the peaks, frees the program, remakes
the data and runs the plain reference (gpubench/reference.py) to judge
the last path's z. The last line of standard output is one JSON object;
the numbers compared and their limits are the last lines of standard
error and the last key of that object. `--trace 1` reports the per-layer
metrics instead of the end-to-end ones: it samples the card's
utilization through the window, times K1 alone on the cell's tail
stream, and profiles one more path.

Exits non-zero, printing no result, without a card (there is no CPU
fallback), with fewer cards than the cell asks for, when the program or a
file of the cell is missing, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".gpubench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "mlease_tpu")


class Refused(Exception):
    """A run that prints no result (exit code 2)."""


def load_cell(root: str, workload: str) -> dict:
    """The cell's BENCHMARK.json entries and files, found by name."""
    here = os.path.join(root, "gpubench")

    def read(*parts):
        path = os.path.join(*parts)
        if not os.path.isfile(path):
            raise Refused(f"missing {os.path.relpath(path, root)}")
        with open(path) as f:
            return json.load(f)

    bench = read(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = read(here, "configs", f"{cell['config']}.json")
    traffic = read(here, "traffic", f"{cell['traffic']}.json")
    job = dict(config["job"])
    for k, v in traffic.get("job", {}).items():
        if v is None:
            job.pop(k, None)
        else:
            job[k] = str(v)

    def reported(m):
        return workload in m.get("workloads", [workload])

    return {"bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "job": job,
            "limits": read(here, "limits", f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
            "per_layer": [m for m in bench["per_layer"] if reported(m)],
            "metrics_dir": os.path.join(here, "metrics")}


def load_reader(metrics_dir: str, name: str):
    path = os.path.join(metrics_dir, f"{name}.py")
    if not os.path.isfile(path):
        raise Refused(f"no reader gpubench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_data(spec, seed: int, device):
    """The blocks and held-out rows, made on `device` and handed over on
    the host as the program's BlockedData and test rows."""
    import numpy as np
    import torch
    from gpubench import datagen
    from gpubench.reference import fingerprint
    from mlease_tpu_torch.core.dataset import BlockedData

    B, R, K, n = spec.blocks, spec.rows_per_block, spec.nnz + 1, spec.dim
    idx = np.empty((B, R, K), np.int32)
    val = np.empty((B, R, K), np.float32)
    y = np.empty((B, R), np.float32)
    present = np.empty((B, n), bool)
    prints = {}
    for b, i, v, yy in datagen.blocks(spec, seed, device):
        prints[b] = fingerprint(i, v, yy)
        p = torch.zeros(n, dtype=torch.bool, device=device)
        p[i[v != 0].long()] = True
        p[n - 1] = True
        idx[b], val[b], y[b] = i.cpu().numpy(), v.cpu().numpy(), \
            yy.cpu().numpy()
        present[b] = p.cpu().numpy()
        del i, v, yy, p
    data = BlockedData(indices=idx, values=val, y=y,
                       weight=np.ones((B, R), np.float32),
                       offset=np.zeros((B, R), np.float32),
                       present=present, nrows=np.full(B, R, np.int32),
                       nblocks=B, dim=n)
    ti, tv, ty = (t.cpu().numpy() for t in datagen.test_rows(spec, seed,
                                                             device))
    names = [f"f{j}" for j in range(spec.n_features)]
    nnz = spec.nnz
    rows = [{"features": [(names[c], x) for c, x in zip(cs, xs)],
             "response": 1 if label > 0 else 0, "weight": 1.0,
             "offset": 0.0}
            for cs, xs, label in zip(ti[:, :nnz].tolist(),
                                     tv[:, :nnz].tolist(), ty.tolist())]
    return data, rows, names, prints


def build_trainer(job: dict, box: list, vocab, test_rows, device):
    """The trainer as the train pipeline builds it, from the data in
    `box`, which it empties (the pipeline drops its packed data once the
    streamed groups are split out of it)."""
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.train.admm import AdmmTrainer
    from mlease_tpu_torch.train.pipeline import (_streaming_trainer,
                                                 admm_config_from_job)
    from mlease_tpu_torch.utils.config import JobConfig

    config = JobConfig()
    for k, v in job.items():
        config.put(k, v)
    cfg = admm_config_from_job(config)
    data = box.pop()
    groups = config.get_int("streaming.groups", 0)
    if groups > 1:
        parts = split_blocks(data, groups)
        del data
        return _streaming_trainer(config, cfg, parts, vocab,
                                  test_rows=test_rows, device=device)
    return AdmmTrainer(data, vocab, cfg, test_rows=test_rows, device=device)


def run_path(trainer, paths: list, sync) -> object:
    """One whole lambda path from z = 0, each iteration's end read by the
    host clock in the callback."""
    import numpy as np
    marks: list[float] = []

    def clock(**_):
        marks.append(time.perf_counter())

    start = time.perf_counter()
    res = trainer.run(callback=clock)
    sync()
    end = time.perf_counter()
    paths.append({"start": start, "marks": marks, "end": end,
                  "solver_stats": res.solver_stats,
                  "trip_log": [t.tolist() for t in
                               getattr(trainer, "trip_log", [])],
                  "finite": bool(np.isfinite(res.z).all()),
                  "maxdiff": [max(d.values()) for d in res.diff_history]})
    return res


def problem_shapes(spec, job: dict, seed: int, device):
    """Each solve's shape (gpubench/roofline.ProblemShape), counted on
    the data remade from the seed, and the first solve's tail stream."""
    import torch
    from gpubench import datagen, roofline, trace
    from gpubench.reference import group_blocks

    H = int(job.get("head.size", 0))
    hsize = 2 if job.get("head.dtype") == "bfloat16" else 4
    L = len(str(job["lambda"]).split(","))
    shapes, first = [], None
    for which in group_blocks(spec.blocks,
                              int(job.get("streaming.groups", 0) or 1)):
        made = list(datagen.blocks(spec, seed, device, which))
        idx = torch.stack([m[1] for m in made])
        val = torch.stack([m[2] for m in made])
        del made
        stream = trace.tail_stream(idx, val, spec.dim, H)
        del idx, val
        vals, gidx, seg, T, S, rows = stream
        shapes.append(roofline.ProblemShape(
            R=rows, N=S, T=T, H=H, L=L, head_itemsize=hsize))
        if first is None:
            first = stream
        del stream, vals, gidx, seg
    return shapes, first


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             root: str = ROOT, device: str = "cuda", log=None) -> dict:
    """One run of the cell; the result object the last line prints."""
    import numpy as np
    import torch
    from gpubench import datagen, reference

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    c = load_cell(root, workload)
    spec = datagen.DataSpec.from_config(c["config"]["data"])
    job = c["job"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    from mlease_tpu_torch.core.vocab import FeatureVocab

    t0 = time.monotonic()
    data, test_rows, names, prints = host_data(spec, seed, dev)
    vocab = FeatureVocab.from_names(names)
    del names
    make_s = time.monotonic() - t0
    peaks = {"data": peak_rss_gb()}
    t0 = time.monotonic()
    box = [data]
    del data
    trainer = build_trainer(job, box, vocab, test_rows, dev)
    del test_rows
    gc.collect()
    sync()
    build_s = time.monotonic() - t0
    peaks["build"] = peak_rss_gb()
    warm: list = []
    run_path(trainer, warm, sync)
    setup_s = time.monotonic() - T_START
    peaks["warm-up"] = peak_rss_gb()
    log(f"set-up {setup_s:.2f} s (data {make_s:.2f}, build {build_s:.2f}, "
        f"warm-up path {warm[0]['end'] - warm[0]['start']:.2f})")

    sampler = None
    if traced and on_card:
        from gpubench.trace import UtilSampler
        sampler = UtilSampler(torch.cuda.current_device())
    paths: list = []
    answers: list = []          # every distinct z the window's paths gave
    w0 = time.perf_counter()
    while True:
        res = run_path(trainer, paths, sync)
        if not any(np.array_equal(res.z, a) for a in answers):
            answers.append(np.array(res.z, dtype=np.float64))
        if paths[-1]["end"] - w0 >= seconds:
            break
    window_s = paths[-1]["end"] - w0
    util = sampler.stop() if sampler is not None else None
    del res
    record = {
        "setup_s": setup_s, "build_s": build_s, "paths": paths,
        "window_s": window_s, "rows": spec.rows, "nvml_util": util,
        "wire_bytes_per_iter": (trainer.stream_wire_bytes()
                                if hasattr(trainer, "stream_wire_bytes")
                                else None)}
    breakdown = None
    if traced and on_card:
        from torch.profiler import ProfilerActivity, profile, record_function
        from gpubench.trace import read_profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("gpubench.path"):
                run_path(trainer, [], sync)
        breakdown = read_profile(prof)
        del prof
    record["rss_peak_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    peaks["window"] = peak_rss_gb()
    log("host peak RSS after each stage, GB: " + ", ".join(
        f"{k} {v:.6f}" for k, v in peaks.items()))
    mem_peak = torch.cuda.max_memory_reserved(dev) if on_card else 0

    # the window has closed: the program's state goes, then the reference
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded in this process: {', '.join(found)}")
    if traced:
        from gpubench.trace import time_k1
        shapes, (vals, gidx, seg, T, S, rows) = problem_shapes(
            spec, job, seed, dev)
        L = shapes[0].L
        record["shapes"] = shapes
        record["k1"] = {"T": T, "S": S, "rows": rows, "L": L,
                        "seconds": (time_k1(vals, gidx, seg, S, rows, L)
                                    if on_card else None)}
        del vals, gidx, seg
        if on_card:
            torch.cuda.empty_cache()
    t0 = time.monotonic()
    ref = reference.run(spec, seed, reference.Job.from_keys(job), dev,
                        log=log)
    ref_s = time.monotonic() - t0
    if ref.fingerprints != prints:
        raise Refused("the data remade from the seed for the reference "
                      "differs from the data the program was given")
    z_ref = ref.z.numpy()
    # the widest gap of any answer the window gave (one, unless paths on
    # the same inputs disagreed)
    gap = max(z_gap(z, z_ref) for z in answers)
    for a in answers:
        d = np.linalg.norm(a - z_ref, axis=1) / np.linalg.norm(z_ref, axis=1)
        j = np.abs(a - z_ref).argmax(1)
        log(f"z gap by lambda {d.tolist()}; widest coordinate "
            f"{j.tolist()}: program {a[np.arange(len(j)), j].tolist()}, "
            f"reference {z_ref[np.arange(len(j)), j].tolist()}")
    limit = float(c["limits"]["z_gap"])
    finite = all(p["finite"] for p in paths)
    correct = bool(finite and np.isfinite(gap) and gap <= limit)
    prog_trips = [(s["newton_trips"], s["cg_trips"])
                  for s in paths[-1]["solver_stats"]]
    log(f"reference {ref_s:.2f} s; program trips {prog_trips}; reference "
        f"trips {[tuple(map(sum, zip(*t))) for t in ref.trips]}")
    log(f"program maxdiff by iteration {paths[-1]['maxdiff']}")

    wanted = c["per_layer"] if traced else c["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load_reader(c["metrics_dir"], m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    iters = sum(len(p["marks"]) for p in paths)
    failed = sum(0 if p["finite"] else len(p["marks"]) for p in paths)
    out = {"correct": correct, "attempted": iters, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if on_card
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if traced and breakdown is not None:
        out["device"]["busy_s"] = breakdown["busy_s"]
        out["device"]["window_s"] = breakdown["window_s"]
        out["breakdown"] = {"device_ops": breakdown["device_ops"],
                            "idle_gaps": breakdown["idle_gaps"]}
    out["compared"] = {"z_gap": {"value": gap, "limit": limit}}
    log(f"metrics {json.dumps(metrics)} (of {[m['name'] for m in wanted]})")
    log(f"window {window_s:.3f} s, {len(paths)} paths, {iters} iterations, "
        f"{len(answers)} distinct answer(s)")
    for p in paths:
        it = [b - a for a, b in zip([p["start"]] + p["marks"], p["marks"])]
        log(f"path {p['end'] - p['start']:.3f} s: first iteration "
            f"{it[0]:.3f}, median {sorted(it)[len(it) // 2]:.3f}, after "
            f"the last {p['end'] - p['marks'][-1]:.3f}")
    return out


def z_gap(z_prog, z_ref) -> float:
    """The widest relative gap over the lambda lanes of the final
    consensus: max over lanes of |z - z_ref|_2 / |z_ref|_2."""
    import numpy as np
    d = np.linalg.norm(np.asarray(z_prog) - np.asarray(z_ref), axis=1)
    return float(np.max(d / np.maximum(np.linalg.norm(z_ref, axis=1),
                                       1e-300)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the run writes lies at a fixed path in the checkout
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    try:
        import torch
        cell = load_cell(ROOT, args.workload)["cell"]
        import mlease_tpu_torch  # noqa: F401
    except (Refused, ImportError) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"gpubench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr, flush=True)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except Refused as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 2
    print(f"correct = {out['correct']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
