from mlease_tpu_torch.utils.config import ConfigError, JobConfig
from mlease_tpu_torch.utils import checkpoint

__all__ = ["ConfigError", "JobConfig", "checkpoint"]
