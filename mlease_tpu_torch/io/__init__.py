from mlease_tpu_torch.io.avro import (
    AvroFileReader,
    AvroFileWriter,
    enumerate_avro_files,
    read_records,
    write_records,
)
from mlease_tpu_torch.io import schemas
from mlease_tpu_torch.io.records import (
    INTERCEPT_NAME,
    feature_key,
    get_response,
    normalize_row,
    prepare_record_to_row,
    row_to_prepare_record,
    split_feature_key,
)

__all__ = [
    "AvroFileReader",
    "AvroFileWriter",
    "enumerate_avro_files",
    "read_records",
    "write_records",
    "schemas",
    "INTERCEPT_NAME",
    "feature_key",
    "get_response",
    "normalize_row",
    "prepare_record_to_row",
    "row_to_prepare_record",
    "split_feature_key",
]
