from mlease_tpu_torch.core.vocab import FeatureVocab, build_vocab
from mlease_tpu_torch.core.linear_model import (
    LinearModel,
    mean_model,
    read_model_file,
    write_model_file,
)
from mlease_tpu_torch.core.dataset import Block, BlockedData, pack_blocks, pack_rows
from mlease_tpu_torch.core.prepare import (
    prepare_rows,
    prepare_to_blocks,
    prepare_to_keyed,
    read_prepared,
    write_prepared,
)

__all__ = [
    "FeatureVocab", "build_vocab",
    "LinearModel", "mean_model", "read_model_file", "write_model_file",
    "Block", "BlockedData", "pack_blocks", "pack_rows",
    "prepare_rows", "prepare_to_blocks", "prepare_to_keyed",
    "read_prepared", "write_prepared",
]
