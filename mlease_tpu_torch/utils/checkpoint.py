"""Per-iteration training checkpoints (crash resume).

The reference's checkpoint story is implicit: every ADMM iteration persists
z/u/models under `<out>/iter-i/` on HDFS, so a crashed run can be manually
resumed from the last completed iteration (reference:
RegressionAdmmTrain.java:281-331, SURVEY.md section 5 checkpoint/resume).
Here the same state — (z, u, iteration, inner_eps, mindiff, best loglik) —
is written explicitly per iteration as an .npz + JSON manifest, and
`load_latest` resumes the driver loop exactly where it stopped.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def save_checkpoint(ckpt_dir: str, iteration: int, z: np.ndarray,
                    u: np.ndarray, *, inner_eps: float, mindiff: float,
                    best_loglik: float = -9999999.0,
                    extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"iter-{iteration:05d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, z=np.asarray(z), u=np.asarray(u))
    os.replace(tmp, path)
    manifest = {
        "iteration": iteration,
        "inner_eps": float(inner_eps),
        "mindiff": float(mindiff),
        "best_loglik": float(best_loglik),
        "array_file": os.path.basename(path),
    }
    if extra:
        manifest.update(extra)
    mpath = os.path.join(ckpt_dir, f"iter-{iteration:05d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def load_latest(ckpt_dir: str) -> dict[str, Any] | None:
    if not os.path.isdir(ckpt_dir):
        return None
    manifests = sorted(f for f in os.listdir(ckpt_dir)
                       if f.startswith("iter-") and f.endswith(".json"))
    if not manifests:
        return None
    with open(os.path.join(ckpt_dir, manifests[-1])) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(ckpt_dir, manifest["array_file"]))
    manifest["z"] = arrays["z"]
    manifest["u"] = arrays["u"]
    return manifest


def prune_checkpoints(ckpt_dir: str, keep: int = 2) -> None:
    """Keep only the newest `keep` checkpoints (the reference's
    remove.tmp.dir analogue, RegressionAdmmTrain.java:475-479)."""
    if not os.path.isdir(ckpt_dir):
        return
    stems = sorted({f.rsplit(".", 1)[0] for f in os.listdir(ckpt_dir)
                    if f.startswith("iter-")})
    for stem in stems[:-keep] if keep else stems:
        for ext in (".npz", ".json"):
            p = os.path.join(ckpt_dir, stem + ext)
            if os.path.exists(p):
                os.remove(p)
