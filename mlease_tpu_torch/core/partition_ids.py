"""Partition-id assignment for per-key training.

A copy of mlease_tpu/core/partition_ids.py (imports renamed, logic
unchanged). API-parity module for the reference's PartitionIdAssigner MapReduce job
(reference: src/main/java/com/linkedin/mlease/regression/jobs/PartitionIdAssigner.java:41-101),
which exists only because Hadoop needs every "lambda#key" group pre-assigned
to a numbered reducer (`RegressionNaiveTrain.java:103-123` heavy-per-item
mode). On TPU the shuffle is gone — host-side grouping replaces it — so this
reduces to deterministic sequential id assignment over the distinct keys, kept
for config/workflow parity and for writing the same map file.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence


def assign_partition_ids(keys: Iterable[str],
                         lambdas: Sequence[float] | None = None) -> dict[str, int]:
    """Distinct (sorted) "lambda#key" strings -> sequential ids.

    When `lambdas` is given, the cross product "lambda#key" is enumerated as
    the reference's mapper does (PartitionIdAssigner.java:60-76); otherwise
    the keys are used as-is.
    """
    if lambdas is not None:
        from mlease_tpu_torch.train.admm import _lambda_key

        combined = sorted({f"{_lambda_key(l)}#{k}"
                           for l in lambdas for k in keys})
    else:
        combined = sorted(set(keys))
    return {k: i for i, k in enumerate(combined)}


def write_partition_ids(path: str, assignment: Mapping[str, int]) -> None:
    """Write the {key -> id} map as Avro (the job's output consumed by
    ReadPartitionIdAssignmentConsumer)."""
    from mlease_tpu_torch.io import avro

    schema = {
        "type": "record",
        "name": "PartitionIdAssignment",
        "namespace": "com.linkedin.mlease.regression.avro",
        "fields": [{"name": "key", "type": "string"},
                   {"name": "value", "type": "int"}],
    }
    avro.write_records(path, schema,
                       [{"key": k, "value": v}
                        for k, v in sorted(assignment.items())])


def read_partition_ids(path: str) -> dict[str, int]:
    from mlease_tpu_torch.io import avro

    return {rec["key"]: int(rec["value"]) for rec in avro.read_records(path)}
