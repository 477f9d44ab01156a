from mlease_tpu_torch.ops import admm_math, objective, tron_multi
from mlease_tpu_torch.ops.newton import newton_cholesky
from mlease_tpu_torch.ops.tron import tron, tron_batched

__all__ = [
    "admm_math", "objective", "tron_multi", "newton_cholesky", "tron",
    "tron_batched",
]
