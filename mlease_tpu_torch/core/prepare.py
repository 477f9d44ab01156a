"""Prepare stage: validate rows, assign partitions, replicate clicks.

TPU-native equivalent of the reference's map-only RegressionPrepare job
(reference: src/main/java/com/linkedin/mlease/regression/jobs/RegressionPrepare.java:73-192):

  * partition key = the `map.key` column when configured, else
    floor(uniform * num.blocks) (RegressionPrepare.java:104-114)
  * every positive's weight is divided by num.click.replicates
    (RegressionPrepare.java:158-162)
  * with random partitioning, each positive is replicated into
    num.click.replicates *consecutive* partitions (mod nblocks)
    (RegressionPrepare.java:172-186) so each block sees enough positives for
    good consensus

Here this is a host-side streaming pass (no MapReduce job); the output either
stays in memory as (partition, row) pairs or is written as
RegressionPrepareOutput Avro for parity with the reference's on-disk layout.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping

import numpy as np

from mlease_tpu_torch.io.records import normalize_row, row_to_prepare_record


def prepare_rows(records: Iterable[Mapping[str, Any]], nblocks: int, *,
                 map_key: str = "", num_click_replicates: int = 1,
                 ignore_value: bool = False,
                 seed: int = 0) -> Iterator[tuple[str, dict]]:
    """Yield (partition_key, canonical_row) pairs."""
    rng = np.random.default_rng(seed)
    for record in records:
        row = normalize_row(record, ignore_value=ignore_value)
        if map_key:
            v = record.get(map_key)
            if v is None:
                raise ValueError(
                    "map.key is wrongly specified! No such key exists in some "
                    "lines of the data!")
            key = str(v)
        else:
            key = str(int(rng.random() * nblocks))

        if row["response"] == 1:
            row = dict(row)
            row["weight"] = row["weight"] / num_click_replicates

        if not map_key and row["response"] == 1:
            partition = int(key)
            for _ in range(num_click_replicates):
                if partition >= nblocks:
                    partition -= nblocks
                yield str(partition), row
                partition += 1
        else:
            yield key, row


def prepare_to_blocks(records: Iterable[Mapping[str, Any]], nblocks: int, *,
                      map_key: str = "", num_click_replicates: int = 1,
                      ignore_value: bool = False,
                      seed: int = 0) -> list[list[dict]]:
    """Prepared rows grouped into nblocks lists (random-partition mode)."""
    out: list[list[dict]] = [[] for _ in range(nblocks)]
    for key, row in prepare_rows(records, nblocks, map_key=map_key,
                                 num_click_replicates=num_click_replicates,
                                 ignore_value=ignore_value, seed=seed):
        out[int(key)].append(row)
    return out


def prepare_to_keyed(records: Iterable[Mapping[str, Any]], *,
                     map_key: str, ignore_value: bool = False) -> dict[str, list[dict]]:
    """Per-item grouping (map.key column mode) for per-key training
    (reference: ItemModelTrain mapper keys by item, ItemModelTrain.java:130-142)."""
    out: dict[str, list[dict]] = {}
    for key, row in prepare_rows(records, nblocks=1, map_key=map_key,
                                 ignore_value=ignore_value):
        out.setdefault(key, []).append(row)
    return out


def write_prepared(path: str, prepared: Iterable[tuple[str, Mapping]]) -> None:
    """Write (key, row) pairs as a RegressionPrepareOutput Avro file."""
    from mlease_tpu_torch.io import avro, schemas

    avro.write_records(
        path, schemas.REGRESSION_PREPARE_OUTPUT,
        (row_to_prepare_record(k, r) for k, r in prepared))


def read_prepared(path: str, nblocks: int,
                  ignore_value: bool = False) -> list[list[dict]]:
    """Read a RegressionPrepareOutput Avro file back into per-block rows."""
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.io.records import prepare_record_to_row

    out: list[list[dict]] = [[] for _ in range(nblocks)]
    for rec in avro.read_records(path):
        out[int(rec["key"])].append(
            prepare_record_to_row(rec, ignore_value=ignore_value))
    return out
