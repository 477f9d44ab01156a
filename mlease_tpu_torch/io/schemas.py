"""Wire-format schemas, matching the reference's Avro schemas 1:1.

These are the same record shapes as the reference's code-generated Avro types
(reference: src/main/avro/*.avsc — RegressionPrepareOutput, RegressionTrainOutput,
LinearModelAvro, LinearModelWithVarAvro, LambdaRhoMap, SampleTestLoglik,
RegressionTestLoglikOutput), so model files written by this framework are
readable by the reference and vice versa.
"""

from __future__ import annotations

NAMESPACE = "com.linkedin.mlease.regression.avro"
MODEL_NAMESPACE = "com.linkedin.mlease.avro"


def _feature_record(name: str = "feature") -> dict:
    return {
        "type": "record",
        "name": name,
        "fields": [
            {"name": "name", "type": "string"},
            {"name": "term", "type": "string"},
            {"name": "value", "type": "float"},
        ],
    }


# reference: src/main/avro/RegressionPrepareOutput.avsc
REGRESSION_PREPARE_OUTPUT = {
    "type": "record",
    "name": "RegressionPrepareOutput",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": _feature_record()}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
    ],
}

# reference: src/main/avro/RegressionTrainOutput.avsc
REGRESSION_TRAIN_OUTPUT = {
    "type": "record",
    "name": "RegressionTrainOutput",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "model", "type": {"type": "array", "items": _feature_record()}},
        {"name": "uplusx", "type": {"type": "array", "items": _feature_record("feature1")}},
    ],
}

# reference: src/main/avro/LinearModelAvro.avsc
LINEAR_MODEL = {
    "type": "record",
    "name": "LinearModelAvro",
    "namespace": MODEL_NAMESPACE,
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "model", "type": {"type": "array", "items": _feature_record()}},
    ],
}

# reference: src/main/avro/LinearModelWithVarAvro.avsc
LINEAR_MODEL_WITH_VAR = {
    "type": "record",
    "name": "LinearModelWithVarAvro",
    "namespace": MODEL_NAMESPACE,
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "model", "type": {"type": "array", "items": _feature_record()}},
        {"name": "posteriorVar",
         "type": {"type": "array", "items": _feature_record("featureVar")}},
    ],
}

# reference: src/main/avro/LambdaRhoMap.avsc
LAMBDA_RHO_MAP = {
    "type": "record",
    "name": "LambdaRhoMap",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "lambda", "type": "float"},
        {"name": "rho", "type": "float"},
    ],
}

# reference: src/main/avro/SampleTestLoglik.avsc
SAMPLE_TEST_LOGLIK = {
    "type": "record",
    "name": "SampleTestLoglik",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "lambda", "type": "string"},
        {"name": "iter", "type": "int"},
        {"name": "testLoglik", "type": "float"},
    ],
}

# reference: src/main/avro/RegressionTestLoglikOutput.avsc
REGRESSION_TEST_LOGLIK_OUTPUT = {
    "type": "record",
    "name": "RegressionTestLoglikOutput",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "testLoglik", "type": "float"},
        {"name": "count", "type": "double"},
    ],
}

# Generic input schema accepted by prepare/scoring: the Pig-style nullable
# schema of examples/sample-data.avro is a superset of this; ingest tolerates
# null-union wrapping on every field.
TRAINING_INPUT = {
    "type": "record",
    "name": "TrainingInput",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "features", "type": {"type": "array", "items": _feature_record()}},
        {"name": "response", "type": "int"},
        {"name": "weight", "type": ["null", "float"], "default": None},
        {"name": "offset", "type": ["null", "float"], "default": None},
    ],
}
