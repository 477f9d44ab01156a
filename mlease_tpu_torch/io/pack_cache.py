"""Packed-dataset cache for fast warm restarts at scale.

Port of mlease_tpu/io/pack_cache.py: the same manifest and the same file
layout, so a cache written by either package loads in the other.

Re-running a large job pays Avro decode + ELL pack + hybrid conversion
before the first iteration; a crash/resume cycle (utils/checkpoint.py
restores z/u/iteration, but the pipeline rebuilds the data) pays it all
again. This cache persists the POST-HYBRID group arrays and the vocabulary
once, then reloads them in roughly one disk scan. It is keyed by a manifest
of everything that shapes the packed layout: the input files (paths +
sizes + mtimes), block/group counts, head size and dtype, click
replicates, prepare seed, binary.feature and map.key. Explicit opt-in via
the `pack.cache.dir` job key.

bfloat16 arrays are stored as uint16 views (the .npy format only
round-trips builtin dtypes) under `<field>__bf16`. The port holds a
bfloat16 head on the host as a `torch.bfloat16` tensor (numpy has no
bfloat16 without ml_dtypes), so it writes that tensor's bits and reads the
view back as a `torch.bfloat16` tensor: the same bytes either way.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import BlockedData
from mlease_tpu_torch.core.vocab import FeatureVocab

logger = logging.getLogger(__name__)

_FIELDS = ("indices", "values", "y", "weight", "offset", "present", "nrows",
           "head", "head_ids", "tail_rows", "tail_cols", "tail_vals",
           "tail_c_rows", "tail_c_cols", "tail_c_vals")


def dtype_name(dtype) -> str:
    """The manifest's dtype string ("float32", "bfloat16", ...) for a numpy
    or torch dtype, as the JAX package writes str(np.dtype(...))."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def build_manifest(input_files: list[str], *, nblocks: int, n_groups: int,
                   head_size: int, head_dtype: str, num_click_replicates: int,
                   seed: int, binary_feature: bool,
                   map_key: str = "") -> dict:
    # version 3: tail padding carries row R-1 (truly row-sorted streams);
    # v2 caches hold row-0 padding and must rebuild, not load.
    return {
        "version": 3,
        "inputs": [[os.path.abspath(p), os.path.getsize(p),
                    int(os.path.getmtime(p))] for p in sorted(input_files)],
        "nblocks": nblocks, "n_groups": n_groups, "head_size": head_size,
        "head_dtype": head_dtype,
        "num_click_replicates": num_click_replicates,
        "seed": seed, "binary_feature": bool(binary_feature),
        "map_key": map_key or "",
    }


def save_groups(cache_dir: str, manifest: dict,
                groups: list[BlockedData], vocab: FeatureVocab) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    for gi, g in enumerate(groups):
        arrays: dict[str, np.ndarray] = {}
        for f in _FIELDS:
            a = getattr(g, f)
            if a is None:
                continue
            if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
                arrays[f + "__bf16"] = (a.contiguous().view(torch.int16)
                                        .numpy().view(np.uint16))
            elif isinstance(a, torch.Tensor):
                arrays[f] = a.numpy()
            else:
                arrays[f] = a
        arrays["__meta"] = np.array([g.nblocks, g.dim], np.int64)
        np.savez(os.path.join(cache_dir, f"group-{gi}.npz"), **arrays)
    vocab.save(os.path.join(cache_dir, "vocab.json"))
    # manifest LAST: its presence marks the cache complete (a crash mid-save
    # leaves no manifest, so the next run rebuilds instead of loading junk)
    with open(os.path.join(cache_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    logger.info("pack cache written: %d groups under %s", len(groups),
                cache_dir)


def load_groups(cache_dir: str,
                manifest: dict) -> tuple[list[BlockedData],
                                         FeatureVocab] | None:
    """Load a cache matching `manifest`, or None (absent/stale/mismatch)."""
    mpath = os.path.join(cache_dir, "manifest.json")
    try:
        with open(mpath) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        return None
    if on_disk != manifest:
        logger.info("pack cache at %s is stale (manifest mismatch); "
                    "rebuilding", cache_dir)
        return None
    groups: list[BlockedData] = []
    for gi in range(manifest["n_groups"]):
        path = os.path.join(cache_dir, f"group-{gi}.npz")
        if not os.path.exists(path):
            return None
        # a damaged-but-complete-looking cache (truncated npz, missing
        # __meta) must trigger a rebuild, not crash the job
        try:
            with np.load(path) as z:
                kw: dict = {f: None for f in _FIELDS}
                nblocks = dim = None
                for key in z.files:
                    if key == "__meta":
                        nblocks, dim = (int(v) for v in z[key])
                    elif key.endswith("__bf16"):
                        kw[key[:-len("__bf16")]] = torch.from_numpy(
                            z[key].view(np.int16)).view(torch.bfloat16)
                    else:
                        kw[key] = z[key]
            if nblocks is None:
                raise KeyError("__meta")
            groups.append(BlockedData(nblocks=nblocks, dim=dim, **kw))
        except (OSError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile) as e:
            logger.warning("pack cache group %s unreadable (%r); rebuilding",
                           path, e)
            return None
    try:
        vocab = FeatureVocab.load(os.path.join(cache_dir, "vocab.json"))
    except (OSError, ValueError, KeyError) as e:
        logger.warning("pack cache vocab unreadable (%r); rebuilding", e)
        return None
    logger.info("pack cache hit: %d groups loaded from %s", len(groups),
                cache_dir)
    return groups, vocab
