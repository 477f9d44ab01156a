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

# numpy has no bfloat16 without ml_dtypes: a bfloat16 array is kept as its
# bits in a 2-byte void dtype, which is what np.save writes for the JAX
# package's (ml_dtypes) bfloat16 arrays and what np.load gives back for them
BF16_BITS = np.dtype("V2")


def host_array(t) -> np.ndarray:
    """A tensor's values as the numpy array a checkpoint holds: bfloat16 as
    its bits (BF16_BITS, the array a JAX run of the same dtype writes), any
    other dtype as it is."""
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def bf16_bits_to_float(a: np.ndarray) -> np.ndarray:
    """bfloat16 bits (BF16_BITS or uint16) -> the same values as float32,
    exactly (a bfloat16 is the upper half of a float32)."""
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def is_bf16_bits(a: np.ndarray) -> bool:
    return a.dtype in (BF16_BITS, np.dtype(np.uint16))


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
