#!/usr/bin/env python3
"""The scale jobs as written, end to end on one card: examples/data/
ctr-12m.job, ctr-25m.job and ctr-100m.job, each run by
`python -m mlease_tpu_torch train <job>` through native Avro ingest, the
pack cache and the streaming trainer.

    python3 tools/torch_scale_jobs.py [--job ctr-12m --job ...]
                                      [--data-dir DIR] [--out FILE.jsonl]
                                      [--dtype bfloat16]

The data is the dataset the JAX package's runs used (ctr-100m.job's
header: examples/make_scale_dataset.py with SCALE_ROWS=100000000
SCALE_PARTS=8): 8 train parts of 12,500,000 rows (seeds 1000-1007) and
test/part-00000.avro of 200,000 rows (seed 999); 1,000,000 features, 12
nonzeros a row on zipf 1.3, labels from w* (seed 12345) with intercept
-1.5; Avro blocks of 4,000 rows, codec null. The generator below is a copy
of that script's, on the port's native encoder, one process a part, and
writes the same bytes (tests/test_torch_scale_jobs.py), with numpy 2.0's
zipf sampler kept (zipf) so that a later numpy draws the same rows. ctr-12m.job reads
part 0, ctr-25m.job parts 0-1, ctr-100m.job all 8; a part already written
is kept. The default directory is examples/data/ctr-10m/, as the jobs name
it (ignored by git). Free disk is checked first (AVRO_BYTES_PER_ROW,
CACHE_BYTES_PER_ROW and the jobs' checkpoints); short of it the script
refuses and writes nothing. It never cuts rows.

Each job is a copy of its example with only input.paths, test.path,
output.base.path and pack.cache.dir pointed into that directory, written
beside the data; with --dtype, a copy that also sets `dtype`, its output
under `<output.base.path>-<dtype>` (not held to the JAX package's float32
run). ctr-12m.job runs once; ctr-25m.job and ctr-100m.job run
twice, the first run writing the pack cache and the second hitting it.
Each run is a process of its own, and prints one JSON line (--out appends
it to a file, the CLI's log beside it): the wall seconds, the process's
own peak RSS (os.wait4) and the host's RAM, the log's ingest breakdown and
rows/s, its `packed` line, pack phases, residency (page-locked and
resident bytes), each streamed iteration (maxdiff, seconds, trips), the
pass-floor decomposition with util, each test loglik, the seconds between
the log's stages, the CLI summary's kernel_launches, and the card's name
and power limit; beside them the JAX package's run on the same data
(JAX_RUNS). A run fails, and the script exits 1, unless: it exits 0; a
first run decoded natively (no Python fallback) and, where the JAX package
ran the job, packed what that run packed; a second run hit the cache,
decoded nothing and wrote final-model/ records equal bit for bit to the
first run's; K1 launched; every row was trained on; each lambda's test
loglik is within LOGLIK_TOL of the JAX run's. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# examples/make_scale_dataset.py at ctr-100m.job's SCALE_ROWS=100000000
# SCALE_PARTS=8 (its defaults otherwise)
N_FEATURES, NNZ, ZIPF_A, INTERCEPT_TRUE = 1_000_000, 12, 1.3, -1.5
N_PARTS, PART_ROWS, TEST_ROWS = 8, 12_500_000, 200_000
TRAIN_SEED, TEST_SEED, W_SEED = 1000, 999, 12345
CHUNK, BLOCK_RECORDS = 50_000, 4000
SCHEMA = {
    "type": "record", "name": "CtrRow", "namespace": "mlease.examples",
    "fields": [
        {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "feature", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "float"}]}}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
    ],
}

JOBS = ("ctr-12m", "ctr-25m", "ctr-100m")
PARTS = {"ctr-12m": 1, "ctr-25m": 2, "ctr-100m": 8}   # train parts read
RUNS = {"ctr-12m": 1, "ctr-25m": 2, "ctr-100m": 2}
PATH_KEYS = ("input.paths", "test.path", "output.base.path",
             "pack.cache.dir")
# disk a train row takes: its Avro (117 bytes written) and, for a job
# with pack.cache.dir, its pack cache (the bfloat16 head of 128 columns,
# both tail orders, y / weight / offset: about 420 bytes); a checkpoint
# holds u (lambdas x blocks x features, float64), two kept
AVRO_BYTES_PER_ROW = 125
CACHE_BYTES_PER_ROW = 450
LOGLIK_TOL = 1e-3
RSS_EVERY_S = 0.5

# the JAX package's runs of the same jobs on the same data (on its TPU:
# model quality and the packed layout only, no time); ctr-12m.job has none
JAX_RUNS = {
    "ctr-100m": {
        "source": "tools/run_100m_r5.log:9, :16-24",
        "packed": ("packed 32 blocks, 100000000 rows padded to "
                   "(3127576, 16), 1000001 features"),
        "test_loglik": {"1.0": -0.473170, "10.0": -0.473174,
                        "100.0": -0.474848},
        "maxdiff": [1.50583, 0.378338, 0.153302, 0.100316, 0.0747638],
        "trips": [[48, 144], [32, 96], [32, 96], [32, 96], [32, 96]]},
    "ctr-25m": {
        "source": "tools/run_25m_r5.log:36, :42-50 (the run of 14:00)",
        "packed": ("packed 16 blocks, 25000000 rows padded to "
                   "(1565368, 16), 997833 features"),
        "test_loglik": {"1.0": -0.473811, "10.0": -0.473639,
                        "100.0": -0.479050},
        "maxdiff": [1.50699, 0.372791, 0.279373, 0.150253, 0.133648],
        "trips": [[24, 72], [16, 48], [16, 48], [16, 48], [16, 48]]},
}


# ---- the dataset ------------------------------------------------------

def _w_true():
    import numpy as np
    rng = np.random.default_rng(W_SEED)
    return (rng.normal(size=N_FEATURES) * 0.3).astype(np.float32)


_INT64_MAX = float(2 ** 63)


def zipf(rng, a: float, size) -> "np.ndarray":
    """rng.zipf(a, size) as numpy up to 2.0 draws it from rng's stream,
    whatever numpy is installed: later numpy draws other values from the
    same stream (the card's numpy 2.3 gave ctr-25m's rows 997,736
    features where the JAX run's data has 997,833). The rejection sampler
    of numpy 2.0's distributions.c, vectorised: U = 1 - u and V from two
    doubles a trial, X = floor(U^(-1/(a-1))), rejected past int64, kept
    when V·X·(T-1)/(b-1) <= T/b with T = (1 + 1/X)^(a-1), b = 2^(a-1);
    the stream then moves past exactly the trials used. Where numpy's
    vector pow could differ from the C library's in its last bit and so
    move a floor or a comparison, math.pow (the C library's) decides."""
    import math
    import numpy as np

    am1 = a - 1.0
    e, b = -1.0 / am1, math.pow(2.0, am1)
    n = int(np.prod(size))
    out = np.empty(n, np.int64)
    gen = rng.bit_generator
    k = 0
    while k < n:
        need = n - k
        state = gen.state
        trials = 2 * need + 1024
        d = rng.random(2 * trials)
        U, V = 1.0 - d[0::2], d[1::2]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            y = U ** e
            near = (y >= 2.0 ** 50) | (np.abs(y - np.rint(y))
                                       <= 8 * np.spacing(y))
            for i in np.flatnonzero(near):
                y[i] = math.pow(U[i], e)
            X = np.floor(y)
            ok = (X <= _INT64_MAX) & (X >= 1.0)
            X = np.where(ok, X, 1.0)
            T = (1.0 + 1.0 / X) ** am1
            lhs = V * X * (T - 1.0) / (b - 1.0)
            rhs = T / b
            tol = 4e-15 * T / np.maximum(T - 1.0, 1e-300) + 1e-14
            for i in np.flatnonzero(ok & (np.abs(lhs - rhs) <= tol * rhs)):
                t = math.pow(1.0 + 1.0 / X[i], am1)
                lhs[i] = V[i] * X[i] * (t - 1.0) / (b - 1.0)
                rhs[i] = t / b
        kept = np.flatnonzero(ok & (lhs <= rhs))[:need]
        out[k:k + len(kept)] = X[kept].astype(np.int64)
        k += len(kept)
        gen.state = state
        gen.advance(int(2 * (kept[-1] + 1 if len(kept) == need
                             else trials)))
    return out.reshape(size)


def write_part(path: str, n_rows: int, seed: int) -> None:
    """One part of the dataset, as make_scale_dataset.py::_write_part
    writes it: chunks of CHUNK rows drawn from `seed`, each encoded in
    Avro blocks of BLOCK_RECORDS rows. Written under a temporary name and
    renamed once whole."""
    import numpy as np
    from mlease_tpu_torch.io import avro, fast_encode

    if not fast_encode.is_available():
        raise RuntimeError("the port's native encoder did not build")
    rng = np.random.default_rng(seed)
    w = _w_true()
    tmp = path + ".partial"
    with avro.AvroFileWriter(tmp, SCHEMA, codec="null",
                             block_records=BLOCK_RECORDS) as out:
        done = 0
        while done < n_rows:
            m = min(CHUNK, n_rows - done)
            cols = (zipf(rng, ZIPF_A, (m, NNZ)) - 1) % N_FEATURES
            vals = (rng.normal(size=(m, NNZ)) * 0.5).astype(np.float32)
            score = np.einsum("rk,rk->r", vals, w[cols]) + INTERCEPT_TRUE
            y = (rng.random(m) < 1.0 / (1.0 + np.exp(-score))).astype(int)
            for s in range(0, m, BLOCK_RECORDS):
                e = min(s + BLOCK_RECORDS, m)
                out.append_raw_block(fast_encode.encode_ctr_block(
                    cols[s:e].astype(np.int32), vals[s:e],
                    y[s:e].astype(np.int32)), e - s)
            done += m
    os.replace(tmp, path)


def dataset_files(data_dir: str, n_parts: int) -> list:
    """(path, rows, seed) of the test file and the first n_parts parts."""
    files = [(os.path.join(data_dir, "test", "part-00000.avro"), TEST_ROWS,
              TEST_SEED)]
    files += [(os.path.join(data_dir, "train", f"part-{p:05d}.avro"),
               PART_ROWS, TRAIN_SEED + p) for p in range(n_parts)]
    return files


def make_dataset(data_dir: str, n_parts: int) -> dict:
    """Write what is missing of the dataset, one process a file."""
    from mlease_tpu_torch.io import fast_encode

    todo = [f for f in dataset_files(data_dir, n_parts)
            if not os.path.exists(f[0])]
    for d in ("train", "test"):
        os.makedirs(os.path.join(data_dir, d), exist_ok=True)
    if not fast_encode.is_available():   # built once, before the workers
        raise RuntimeError("the port's native encoder did not build")
    t0 = time.monotonic()
    procs = [mp.get_context("fork").Process(target=write_part, args=f)
             for f in todo]
    for p in procs:
        p.start()
    bad = []
    for p, f in zip(procs, todo):
        p.join()
        if p.exitcode != 0:
            bad.append(f"{f[0]}: exit {p.exitcode}")
    if bad:
        raise RuntimeError(f"dataset writers failed: {bad}")
    return {"written": [os.path.relpath(f[0], data_dir) for f in todo],
            "s": time.monotonic() - t0,
            "bytes": sum(os.path.getsize(f[0])
                         for f in dataset_files(data_dir, n_parts))}


def disk_needed(data_dir: str, jobs) -> int:
    """Bytes still to be written under data_dir by these jobs: the
    missing dataset files, pack caches, checkpoints and outputs."""
    need = 0
    for path, rows, _seed in dataset_files(data_dir, max(PARTS[j]
                                                         for j in jobs)):
        if not os.path.exists(path):
            need += rows * AVRO_BYTES_PER_ROW
    for name in jobs:
        cfg = example_job(name)
        rows = PARTS[name] * PART_ROWS
        if "pack.cache.dir" in cfg:
            need += rows * CACHE_BYTES_PER_ROW
        lambdas = len(cfg["lambda"].split(","))
        need += 2 * lambdas * int(cfg["num.blocks"]) * (N_FEATURES + 1) * 8
        need += 1 << 30                  # models, scored test rows, logs
    return need


# ---- the jobs ---------------------------------------------------------

def _job_lines(name: str) -> list:
    with open(os.path.join(REPO, "examples", "data", f"{name}.job")) as f:
        return f.read().splitlines()


def _key_value(line: str):
    s = line.strip()
    if not s or s.startswith(("#", "!")) or "=" not in s:
        return None
    k, v = s.split("=", 1)
    return k.strip(), v.strip()


def example_job(name: str) -> dict:
    return dict(kv for kv in map(_key_value, _job_lines(name)) if kv)


def job_text(name: str, data_dir: str, dtype: str | None = None) -> str:
    """The example job with its path keys pointed into data_dir: each
    path's place under the example's data directory (the one holding its
    test.path) kept, every other line as written. With `dtype` the job
    also sets the compute dtype, and writes its output beside the job's
    own, under `<output.base.path>-<dtype>`."""
    base = os.path.dirname(example_job(name)["test.path"])
    out = []
    for line in _job_lines(name):
        kv = _key_value(line)
        if kv and kv[0] in PATH_KEYS:
            paths = [os.path.join(os.path.abspath(data_dir),
                                  os.path.relpath(p.strip(), base))
                     for p in kv[1].split(",")]
            if dtype and kv[0] == "output.base.path":
                paths = [f"{p}-{dtype}" for p in paths]
            line = f"{kv[0]} = {','.join(paths)}"
        out.append(line)
    if dtype:
        out.append(f"dtype = {dtype}")
    return "\n".join(out) + "\n"


def job_file(name: str, dtype: str | None = None) -> str:
    return f"{name}.{dtype}.job" if dtype else f"{name}.job"


def write_job(name: str, data_dir: str, dtype: str | None = None) -> str:
    path = os.path.join(data_dir, job_file(name, dtype))
    with open(path, "w") as f:
        f.write(job_text(name, data_dir, dtype))
    return path


# ---- reading a run's log ------------------------------------------------

_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ")
_ITER = re.compile(r"stream iter (\d+): maxdiff=(\S+) \(([\d.]+)s, (\d+) "
                   r"newton / (\d+) cg trips over (\d+) groups\)")
_LOGLIK = re.compile(r"test loglik (\S+): (\S+) \(n=(\d+)\)")
_PACKED = re.compile(r"(packed \d+ blocks, (\d+) rows padded to \((\d+), "
                     r"(\d+)\), (\d+) features)")
# a stage of the run, by the first line that holds its tag
STAGES = (("ingested", "native ingest: "),
          ("cache_loaded", "pack cache hit: ingest/pack skipped"),
          ("packed", "packed "),
          ("cache_written", "streaming pack phases: "),
          ("built", "streaming residency: "),
          ("first_iter", "stream iter 1:"),
          ("floor", "streaming pass-floor decomposition: "),
          ("scored", "test loglik "))


def parse_log(text: str) -> dict:
    """What a `train` run's log (the CLI's stderr at INFO) says of the
    scale path; absent stages are left out."""
    row: dict = {"native_ingest": "native ingest:" in text,
                 "python_fallback": "python path" in text,
                 "cache_written": "pack cache written" in text,
                 "cache_hit": "pack cache hit" in text,
                 "iters": [], "test_loglik": {}, "stage_s": {},
                 "stage_t": {}}
    t_first = None
    for line in text.splitlines():
        m = _STAMP.match(line)
        t = (datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
             if m else None)
        if t is not None and t_first is None:
            t_first = t
        for stage, tag in STAGES:
            if tag in line and stage not in row["stage_s"] and t:
                row["stage_s"][stage] = (t - t_first).total_seconds()
                row["stage_t"][stage] = t.timestamp()
        if "ingest phase breakdown: " in line:
            s = line.split("ingest phase breakdown: ", 1)[1]
            brk, rate = s.rsplit(";", 1)
            row["ingest"] = json.loads(brk)
            row["ingest_rows_per_s"] = float(rate.split()[0])
        elif "native ingest: " in line:
            row["native_ingest_line"] = line.split("native ingest: ", 1)[1]
        elif (m := _PACKED.search(line)) and "packed" not in row:
            row["packed"] = m.group(1)
            row["rows"] = int(m.group(2))
            row["padded"] = [int(m.group(3)), int(m.group(4))]
            row["features"] = int(m.group(5))
        elif "streaming pack phases: " in line:
            s = line.split("streaming pack phases: ", 1)[1]
            row["pack_phases"] = {k: float(v.rstrip("s")) for k, v in (
                p.split("=") for p in s.split())}
        elif "streaming residency: " in line:
            s = line.split("streaming residency: ", 1)[1]
            rep, wire = s.rsplit(";", 1)
            row["residency"] = json.loads(rep)
            row["wire_gb_per_iter"] = float(wire.split()[0])
        elif "resident mode: " in line:
            row["resident_mode"] = line.split("resident mode: ", 1)[1]
        elif "compact wire: " in line:
            row["compact_wire"] = line.split("compact wire: ", 1)[1]
        elif "tail shapes harmonized" in line:
            row["tail_shapes"] = line.split("INFO ", 1)[-1]
        elif m := _ITER.search(line):
            row["iters"].append({
                "iter": int(m.group(1)), "maxdiff": float(m.group(2)),
                "s": float(m.group(3)), "newton": int(m.group(4)),
                "cg": int(m.group(5)), "groups": int(m.group(6))})
        elif "streaming pass-floor decomposition: " in line:
            row["pass_floor"] = json.loads(line.split(
                "streaming pass-floor decomposition: ", 1)[1])
        elif m := _LOGLIK.search(line):
            row["test_loglik"][m.group(1)] = float(m.group(2))
            row["test_n"] = int(m.group(3))
    return row


# ---- one run ------------------------------------------------------------

def host_ram_bytes() -> int:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemTotal"].split()[0]) * 1024


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _sample_rss(pid: int, samples: list, stop: threading.Event) -> None:
    """(epoch s, VmRSS bytes) of process pid every RSS_EVERY_S."""
    while not stop.wait(RSS_EVERY_S):
        try:
            with open(f"/proc/{pid}/status") as f:
                rss = next(int(line.split()[1]) * 1024 for line in f
                           if line.startswith("VmRSS:"))
        except (OSError, StopIteration):
            return
        samples.append((time.time(), rss))


def rss_by_stage(samples: list, stage_t: dict, t_end: float) -> dict:
    """The largest sampled RSS between each stage of the log and the
    next ("start" from the process's start, the last to its end)."""
    marks = sorted(stage_t.items(), key=lambda kv: kv[1])
    out = {}
    for (name, t0), t1 in zip([("start", 0.0), *marks],
                              [t for _n, t in marks] + [t_end]):
        vals = [r for t, r in samples if t0 <= t < t1]
        if vals:
            out[name] = max(vals)
    return out


def run_train(job: str, log_path: str, timeout_s: float,
              extra=()) -> dict:
    """`python -m mlease_tpu_torch train job [extra]` as a process of its
    own, its stderr to log_path; (exit code, wall s, its own peak RSS, its
    RSS sampled every RSS_EVERY_S, the summary line)."""
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="INFO")
    t0 = time.monotonic()
    samples: list = []
    stop = threading.Event()
    with open(log_path, "w") as err, \
            open(log_path + ".stdout", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlease_tpu_torch", "train", job,
             *extra], stdout=out, stderr=err, env=env, cwd=REPO)
        timer = threading.Timer(timeout_s, proc.kill)
        sampler = threading.Thread(target=_sample_rss,
                                   args=(proc.pid, samples, stop))
        timer.start()
        sampler.start()
        try:
            _pid, status, usage = os.wait4(proc.pid, 0)
        finally:
            timer.cancel()
            stop.set()
            sampler.join()
    proc.returncode = os.waitstatus_to_exitcode(status)
    with open(log_path + ".stdout") as f:
        lines = f.read().strip().splitlines()
    summary = None
    if lines and lines[-1].startswith("{"):
        summary = json.loads(lines[-1])
    return {"rc": proc.returncode, "wall_s": time.monotonic() - t0,
            "peak_rss_bytes": usage.ru_maxrss * 1024, "rss": samples,
            "t_end": time.time(), "summary": summary}


def final_models(out_base: str) -> list:
    from mlease_tpu_torch.io import avro
    return avro.read_records(os.path.join(out_base, "final-model"))


def failures(name: str, k: int, row: dict, first_models, models) -> list:
    """What run k of job `name` got wrong (empty: nothing); a copy in
    another dtype (row["dtype"]) is not held to the JAX package's run."""
    bad = []
    jax = JAX_RUNS.get(name) if row.get("dtype", "float32") == "float32" \
        else None
    if row["rc"] != 0:
        bad.append(f"exit code {row['rc']}")
    if row["python_fallback"]:
        bad.append("the record-at-a-time (python) path ran")
    if k == 1:
        if not row["native_ingest"]:
            bad.append("no native ingest")
        if jax and row.get("packed") != jax["packed"]:
            bad.append(f"packed {row.get('packed')!r}, the JAX run "
                       f"{jax['packed']!r}")
    else:
        if not row["cache_hit"] or row["native_ingest"]:
            bad.append("the second run did not hit the pack cache alone")
        if models != first_models or not models:
            bad.append("final-model/ differs from the first run's")
    if row.get("rows", PARTS[name] * PART_ROWS) != PARTS[name] * PART_ROWS:
        bad.append(f"{row.get('rows')} rows trained, "
                   f"{PARTS[name] * PART_ROWS} in the job's input")
    launches = (row.get("summary") or {}).get("kernel_launches", {})
    if not launches.get("segment_sum_sorted"):
        bad.append(f"K1 not launched: {launches}")
    if jax:
        for lam, want in jax["test_loglik"].items():
            got = row["test_loglik"].get(lam)
            if got is None or abs(got - want) > LOGLIK_TOL:
                bad.append(f"test loglik {lam}: {got} against the JAX "
                           f"run's {want}")
    return bad


def run_job(name: str, data_dir: str, out_dir: str, timeout_s: float,
            card: str, out_file: str, dtype: str | None = None) -> list:
    """Every run of one job (with `dtype`, its copy in that compute
    dtype); the rows of the runs, failures listed."""
    job = write_job(name, data_dir, dtype)
    keys = dict(kv for kv in map(_key_value, job_text(name, data_dir, dtype)
                                 .splitlines()) if kv)
    out_base = keys["output.base.path"]
    if "pack.cache.dir" in keys:      # a first run writes it anew
        shutil.rmtree(keys["pack.cache.dir"], ignore_errors=True)
    rows, first_models = [], None
    for k in range(1, RUNS[name] + 1):
        log = os.path.join(out_dir, f"scale-{job_file(name, dtype)[:-4]}"
                                    f"-run{k}.log")
        got = run_train(job, log, timeout_s)
        with open(log) as f:
            row = dict(parse_log(f.read()), **got)
        row["rss_by_stage"] = rss_by_stage(row.pop("rss"),
                                           row.pop("stage_t"),
                                           row.pop("t_end"))
        models = final_models(out_base) if got["rc"] == 0 else None
        if k == 1:
            first_models = models
        row.update({"job": name, "dtype": dtype or "float32", "run": k,
                    "card": card, "out_base": out_base,
                    "host_ram_bytes": host_ram_bytes(), "log": log,
                    "jax": None if dtype else JAX_RUNS.get(name)})
        row["failures"] = failures(name, k, row, first_models, models)
        print(json.dumps(row), flush=True)
        if out_file:
            with open(out_file, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        if got["rc"] != 0:
            break
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", action="append", choices=JOBS)
    ap.add_argument("--data-dir", default=os.path.join(
        REPO, "examples", "data", "ctr-10m"))
    ap.add_argument("--out", default="",
                    help="append each run's JSON line here; the CLI's "
                         "logs go beside it")
    ap.add_argument("--dtype", choices=("bfloat16",),
                    help="run each job's copy with this compute dtype "
                         "(its output beside the job's own)")
    ap.add_argument("--timeout-s", type=float, default=5400.0,
                    help="the longest one run may take")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    jobs = [j for j in JOBS if j in (args.job or JOBS)]
    data_dir = os.path.abspath(args.data_dir)
    out_dir = os.path.dirname(os.path.abspath(args.out)) if args.out \
        else data_dir
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    need, free = disk_needed(data_dir, jobs), shutil.disk_usage(
        data_dir).free
    print(json.dumps({"disk_free_bytes": free, "disk_needed_bytes": need,
                      "host_ram_bytes": host_ram_bytes(),
                      "cpus": os.cpu_count()}), flush=True)
    if free < need:
        print(f"refused: {need / 1e9:.1f} GB to write under {data_dir}, "
              f"{free / 1e9:.1f} GB free (no rows are cut)",
              file=sys.stderr)
        return 1
    made = make_dataset(data_dir, max(PARTS[j] for j in jobs))
    print("dataset " + json.dumps(made), flush=True)
    failed = []
    for name in jobs:
        for row in run_job(name, data_dir, out_dir, args.timeout_s, card,
                           args.out, args.dtype):
            if row["failures"]:
                failed.append(f"{name} run {row['run']}: "
                              f"{row['failures']}")
    print(card_line(), flush=True)
    if failed:
        print("failed: " + json.dumps(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
