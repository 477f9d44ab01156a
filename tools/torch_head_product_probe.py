#!/usr/bin/env python3
"""Times the two dense-head products of the port's flat-blocks passes
(mlease_tpu_torch/ops/tron_multi.py) in several formulations on one CUDA
card, at the head shapes of chip_smoke.py.

    python3 tools/torch_head_product_probe.py [--out FILE]

  xv:   out[l, b, r] = sum_h hw[l, b, h] * hx[b, r, h]   (`_xv_lm`)
  xtv:  out[l, b, h] = sum_r  D[l, b, r] * hx[b, r, h]   (`_head_t`)

for L lanes. hx (B, Rb, H) float32, the per-block head of the hybrid layout,
is the only large operand, so every formulation is bound by reading it
once: B*Rb*H*4 bytes over 3.35 TB/s (H100 SXM). Each variant is checked
against a float64 product and timed with CUDA events over 10 repeats.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SHAPES = {"bench": (4, 16_384, 512), "full_2m": (8, 262_144, 128),
          "full_12m": (8, 1_562_500, 128)}


def xtv_variants():
    def bmm_view(hx, D):            # the slice-1 form: a strided view of D
        L, B, Rb = D.shape
        return torch.bmm(D.transpose(0, 1), hx).transpose(0, 1)

    def bmm_contiguous(hx, D):
        return torch.bmm(D.transpose(0, 1).contiguous(), hx).transpose(0, 1)

    def bmm_head_major(hx, D):      # (B, H, Rb) x (B, Rb, L)
        return torch.bmm(hx.transpose(1, 2), D.permute(1, 2, 0)) \
            .permute(2, 0, 1)

    def mm_per_block(hx, D):
        return torch.stack([D[:, b] @ hx[b] for b in range(hx.shape[0])], 1)

    def split_k(hx, D):             # row chunks as extra batches, then a sum
        L, B, Rb = D.shape
        c = next((c for c in range(8192, 511, -1) if Rb % c == 0), Rb)
        m = Rb // c
        Dc = D.reshape(L, B * m, c).transpose(0, 1).contiguous()
        part = torch.bmm(Dc, hx.reshape(B * m, c, hx.shape[2]))
        return part.reshape(B, m, L, -1).sum(1).transpose(0, 1)

    return {"bmm_view": bmm_view, "bmm_contiguous": bmm_contiguous,
            "bmm_head_major": bmm_head_major, "mm_per_block": mm_per_block,
            "split_k": split_k}


def variants():
    def bmm_lane_rows(hx, hw):      # (B, L, H) x (B, H, Rb): the slice-1 form
        L, B, H = hw.shape
        return torch.bmm(hw.transpose(0, 1), hx.transpose(1, 2)) \
            .transpose(0, 1)

    def bmm_row_lanes(hx, hw):      # (B, Rb, H) x (B, H, L), then lanes first
        return torch.bmm(hx, hw.permute(1, 2, 0)).permute(2, 0, 1)

    def einsum(hx, hw):
        return torch.einsum("brh,lbh->lbr", hx, hw)

    return {"bmm_lane_rows": bmm_lane_rows, "bmm_row_lanes": bmm_row_lanes,
            "einsum": einsum}


def time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, (B, Rb, H) in SHAPES.items():
        hx = torch.randn((B, Rb, H), generator=gen, device="cuda")
        for L in (3, 6):
            hw = torch.randn((L, B, H), generator=gen, device="cuda")
            ref = torch.einsum("brh,lbh->lbr", hx.double(), hw.double())
            for vname, fn in variants().items():
                got = fn(hx, hw)
                err = float((got.double() - ref).abs().max())
                rows.append({"shape": name, "B": B, "Rb": Rb, "H": H, "L": L,
                             "product": "xv", "variant": vname,
                             "max_abs_err": err,
                             "ms": time_ms(lambda: fn(hx, hw)),
                             "bound_ms": B * Rb * H * 4 / 3.35e12 * 1e3})
                print(json.dumps(rows[-1]), flush=True)
            del ref
            D = torch.randn((L, B, Rb), generator=gen, device="cuda")
            ref = torch.einsum("lbr,brh->lbh", D.double(), hx.double())
            for vname, fn in xtv_variants().items():
                got = fn(hx, D)
                err = float((got.double() - ref).abs().max())
                rows.append({"shape": name, "B": B, "Rb": Rb, "H": H, "L": L,
                             "product": "xtv", "variant": vname,
                             "max_abs_err": err,
                             "ms": time_ms(lambda: fn(hx, D)),
                             "bound_ms": B * Rb * H * 4 / 3.35e12 * 1e3})
                print(json.dumps(rows[-1]), flush=True)
            del ref, D
        del hx
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
