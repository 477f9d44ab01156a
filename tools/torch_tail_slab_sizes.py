#!/usr/bin/env python3
"""How large the TPU kernel `tile_segment_sum`'s padded slab would be on the
port's sparse tails (host-side counting, numpy; no device needed).

    python3 tools/torch_tail_slab_sizes.py [--seed 0]

`mlease_tpu/ops/pallas/tile_sum.py::segment_layout` groups the
column-sorted tail into 128-column tiles and pads every tile to the longest
one, P (rounded up to 8): a slab of C*P slots for C tiles. This script
builds the hybrid layout (`to_hybrid`) of chip_smoke.py's zipf-1.3 data at
two shapes and counts, per block (the layout is built per block) and for
the stacked flat-blocks stream that the port's kernel reduces: tail
entries, the hottest and the mean non-empty tile, and slab slots against
the real stream.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_C = 128
SHAPES = {  # name: (features, blocks, rows per block, nnz/row, head)
    "bench_default": (50_000, 4, 16_384, 15, 512),
    "ctr12m_widths_1m_rows": (1_000_000, 8, 125_000, 12, 128),
}


def slab(cols: np.ndarray, n: int) -> dict:
    counts = np.bincount(cols // TILE_C, minlength=(n + TILE_C - 1) // TILE_C)
    P = -(-max(int(counts.max(initial=1)), 1) // 8) * 8
    slots = counts.size * P
    return {"tail_entries": int(cols.size), "tiles": int(counts.size),
            "hottest_tile": int(counts.max()),
            "mean_nonempty_tile": float(counts[counts > 0].mean()),
            "slab_slots": int(slots), "slab_over_stream": slots / cols.size}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from chip_smoke import synth_blocked_data
    from mlease_tpu_torch.core.dataset import to_hybrid

    for name, (nf, B, R, nnz, head) in SHAPES.items():
        data = to_hybrid(synth_blocked_data(nf, B, R, nnz, args.seed), head)
        n = data.dim
        per_block = [slab(data.tail_c_cols[b], n) for b in range(B)]
        stacked = slab((data.tail_c_cols
                        + np.arange(B)[:, None] * n).reshape(-1), B * n)
        print(json.dumps({"shape": name, "rows": B * R, "columns": n,
                          "head": head, "stacked": stacked,
                          "block_0": per_block[0],
                          "max_block_slab_over_stream": max(
                              p["slab_over_stream"] for p in per_block)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
