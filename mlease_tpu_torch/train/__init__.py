from mlease_tpu_torch.train.admm import AdmmConfig, AdmmResult, AdmmTrainer
from mlease_tpu_torch.train.naive import NaiveConfig, NaiveResult, train_naive
from mlease_tpu_torch.train.item import (
    ItemConfig,
    ItemResult,
    train_item_models,
    write_item_models,
)
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
from mlease_tpu_torch.train.feature_sharded import FeatureShardedAdmmTrainer

__all__ = [
    "AdmmConfig", "AdmmResult", "AdmmTrainer",
    "NaiveConfig", "NaiveResult", "train_naive",
    "ItemConfig", "ItemResult", "train_item_models", "write_item_models",
    "StreamingAdmmTrainer", "FeatureShardedAdmmTrainer",
]
