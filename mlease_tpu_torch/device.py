"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`, "cuda" by default. Asking for
CUDA on a host without a CUDA device raises instead of quietly running on
the CPU; the CPU is used only when the caller names it (the tests do).

float32 matrix products run in full IEEE float32 (no TF32), the counterpart
of the JAX package's `Precision.HIGHEST` on its dense-head products.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
