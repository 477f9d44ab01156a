"""Probe-composed speed-of-light accounting for STREAMING iterations.

Port of mlease_tpu/utils/floor.py: the same functions, formulas and dict
keys, with the per-pass tables of this port (tools/torch_pass_floors*.json,
written by `tools/torch_pass_microbench.py --floors` on the card) and the
torch device in place of jax.devices(). A table is taken only when it was
measured on the same platform ("cuda" or "cpu") and, on "cuda", on a card
of the same name.

    compute_g     = scale_g * (fun_grad_diag + nt_g*(xv + fused_xtv_diag)
                               + cg_g*hv)          [element-scaled]
    compute_floor = sum_g compute_g
    wire_floor    = stream_wire_bytes / bw

With double buffering the wire for group g+1 rides under group g's solve,
so a steady iteration cannot beat max(compute_floor, wire_floor); the util
this module reports divides that max by the measured steady iteration time.
(The first group's transfer is not overlapped — it is part of why util<1,
not part of the floor.)

No reference counterpart: the reference's per-iteration cost model is
"re-read the partition from HDFS and run liblinear"
(RegressionAdmmTrain.java:677-690); it has no utilization accounting at all.
"""

from __future__ import annotations

import glob
import json
import math
import os

import numpy as np
import torch

TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "tools")
TABLE_GLOB = "torch_pass_floors*.json"


def device_identity(device: str | torch.device = "cuda"):
    """(platform, chip) of a torch device: ("cuda", the card's name) or
    ("cpu", None)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, None


def _refusal(tab: dict, plat: str, chip: str | None,
             dtype: torch.dtype | None = None) -> str | None:
    """Why a table does not apply to this device and compute dtype, or None
    when it does. A bfloat16 run takes only a table measured in bfloat16
    ("dtype": "bfloat16", tools/torch_pass_microbench.py --dtype bfloat16),
    and a float32 or float64 run only one measured without it: the passes
    move half the bytes in bfloat16."""
    tab_bf16 = tab.get("dtype") == "bfloat16"
    if dtype is not None and tab_bf16 != (dtype == torch.bfloat16):
        return (f"pass_floors table measured in "
                f"{tab.get('dtype', 'float32')} compute, running in "
                f"{str(dtype).removeprefix('torch.')}")
    if tab.get("platform") != plat:
        return (f"pass_floors table measured on {tab.get('platform')}, "
                f"running on {plat}")
    if chip is not None and tab.get("chip") != chip:
        return (f"pass_floors table measured on {tab.get('chip')}, running "
                f"on {chip}")
    return None


def load_floor_table(path: str | None = None, target_elems: int | None = None,
                     *, device: str | torch.device = "cuda",
                     dtype: torch.dtype | None = None):
    """The measured per-pass table, or (None, reason). Platform-checked:
    floors measured on another backend (or, on the card, another card, or
    in the other of bfloat16 and wider compute, `dtype`) are not
    comparable.

    With no explicit path (nor BENCH_FLOORS), every torch_pass_floors*.json
    of tools/ is considered and the table with
    element count nearest `target_elems` wins: per-pass cost per element is
    not constant across feature widths, so the probe table must come from
    the matching regime."""
    plat, chip = device_identity(device)
    env = os.environ.get("BENCH_FLOORS")
    if path is None and env:
        path = env
    if path is not None:
        try:
            with open(path) as f:
                tab = json.load(f)
        except (OSError, ValueError):
            return None, ("no pass_floors table — run "
                          "tools/torch_pass_microbench.py --floors on the "
                          "card")
        why = _refusal(tab, plat, chip, dtype)
        return (None, why) if why else (tab, None)
    best, best_key, seen = None, None, []
    for p in sorted(glob.glob(os.path.join(TOOLS_DIR, TABLE_GLOB))):
        try:
            with open(p) as f:
                tab = json.load(f)
        except (OSError, ValueError):
            continue
        why = _refusal(tab, plat, chip, dtype)
        if why:
            seen.append(f"{os.path.basename(p)}: {why}")
            continue
        e = max(table_elems(tab), 1)
        key = (abs(math_log_ratio(target_elems, e))
               if target_elems else 0.0)
        if best is None or key < best_key:
            best, best_key = tab, key
    if best is None:
        return None, ("no platform-matching torch_pass_floors*.json — run "
                      "tools/torch_pass_microbench.py --floors on the card"
                      + (f" ({'; '.join(seen)})" if seen else ""))
    return best, None


def math_log_ratio(a: int | None, b: int) -> float:
    if not a:
        return 0.0
    return math.log(max(a, 1) / max(b, 1))


def group_elems(g, n_lambdas: int) -> int:
    """Streamed-element count of one group's pass (the linear scaling
    variable of every pass primitive): B*(R*K + R*H + T)*L. Reads the
    shapes only, so it takes the streaming trainer's host groups as they
    are (pinned tensors, with or without a compact-wire encoding beside
    them) as well as numpy BlockedData."""
    B = g.nblocks
    R = g.indices.shape[1]
    K = g.indices.shape[2]
    H = g.head.shape[2] if g.head is not None else 0
    T = (g.tail_vals.shape[1]
         if getattr(g, "tail_vals", None) is not None else 0)
    return B * (R * K + R * H + T) * n_lambdas


def table_elems(tab: dict) -> int:
    s = tab["shape"]
    return (s["blocks"] * (s["rows"] * s["ell_k"]
                           + s["rows"] * s["head"]
                           + s["tail_nnz_per_block"]) * s["lambdas"])


def streaming_floor(groups, trip_log, wire_bytes: int, steady_iter_s: float,
                    bw_bytes_per_s: float | None, n_lambdas: int,
                    floors_path: str | None = None, *,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """Compose the streaming iteration floor from the probe table.

    groups:    the trainer's (padded) group list
    trip_log:  list of per-iteration (G, 2) newton/cg counter matrices
               (StreamingAdmmTrainer.trip_log)
    wire_bytes: per-iteration host->device data bytes actually shipped
               (trainer.stream_wire_bytes())
    bw_bytes_per_s: measured host->device bandwidth (None -> wire term
               reported as unknown, util computed from compute alone)
    device:    the device the run took (picks the table)
    dtype:     the run's compute dtype (a bfloat16 run takes a bfloat16
               table or none; None: not checked)
    """
    mean_g_elems = (int(np.mean([group_elems(g, n_lambdas)
                                 for g in groups])) if groups else None)
    tab, err = load_floor_table(floors_path, target_elems=mean_g_elems,
                                device=device, dtype=dtype)
    if tab is None:
        return {"floor_iter_s": None, "util": None, "source": err}
    if not trip_log:
        return {"floor_iter_s": None, "util": None,
                "source": "no trip log (zero iterations ran)"}
    # steady per-group trips: drop iteration 1 (cold trips differ) when
    # there are enough iterations to spare
    mats = trip_log[1:] if len(trip_log) > 1 else trip_log
    mean_trips = np.mean(np.stack(mats, axis=0), axis=0)  # (G, 2)
    fl = tab["floors_ms"]
    e_tab = max(table_elems(tab), 1)
    per_group = []
    compute_ms = 0.0
    for gi, g in enumerate(groups):
        elems = group_elems(g, n_lambdas)
        scale = elems / e_tab
        nt, cg = float(mean_trips[gi][0]), float(mean_trips[gi][1])
        g_ms = scale * (fl["fun_grad_diag"]
                        + nt * (fl["xv"] + fl["fused_xtv_diag"])
                        + cg * fl["hv"])
        compute_ms += g_ms
        per_group.append({"scale": round(scale, 4), "nt": round(nt, 1),
                          "cg": round(cg, 1),
                          "floor_ms": round(g_ms, 2)})
    compute_s = compute_ms / 1e3
    wire_s = (wire_bytes / bw_bytes_per_s if bw_bytes_per_s else None)
    floor_s = max(compute_s, wire_s) if wire_s is not None else compute_s
    bound = ("wire" if wire_s is not None and wire_s > compute_s
             else "compute")
    return {
        "floor_iter_s": round(floor_s, 4),
        "util": (round(floor_s / steady_iter_s, 3)
                 if steady_iter_s > 0 else None),
        "bound": bound,
        "compute_floor_s": round(compute_s, 4),
        "wire_floor_s": (round(wire_s, 4) if wire_s is not None else None),
        "wire_bytes_per_iter": int(wire_bytes),
        "bw_gbps": (round(bw_bytes_per_s / 1e9, 3)
                    if bw_bytes_per_s else None),
        "source": (f"composed from probe table @ {tab.get('chip')} "
                   + ("(bfloat16 compute, " if tab.get("dtype") == "bfloat16"
                      else "(")
                   + f"features={tab.get('shape', {}).get('features')}); "
                   "element-scaled per group; util>1 means the in-situ "
                   "solver beats the isolated-pass probe"),
        "per_group": per_group[:32],
    }


def measure_put_bandwidth(n_bytes: int = 1 << 26, tries: int = 3,
                          device: str | torch.device = "cuda"
                          ) -> float | None:
    """Measured host->device bandwidth (bytes/s, best of `tries`): a copy
    from page-locked host memory, timed with CUDA events, the streaming
    floor's wire denominator. None on the CPU (no host->device wire)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    src = torch.ones(n_bytes // 4, dtype=torch.float32, pin_memory=True)
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    best = float("inf")
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return n_bytes / best
