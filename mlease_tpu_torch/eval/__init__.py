from mlease_tpu_torch.eval.score import (
    model_vocab,
    remove_union,
    run_regression_test,
    score_rows_device,
)
from mlease_tpu_torch.eval.loglik import (
    aggregate_loglik,
    record_loglik,
    run_test_loglik,
)
from mlease_tpu_torch.eval.item_score import (
    aggregate_item_loglik,
    run_item_model_test,
    run_item_model_test_loglik,
    score_item_records,
)

__all__ = [
    "model_vocab", "remove_union", "run_regression_test", "score_rows_device",
    "aggregate_loglik", "record_loglik", "run_test_loglik",
    "aggregate_item_loglik", "run_item_model_test",
    "run_item_model_test_loglik", "score_item_records",
]
