from denormalized_tpu_torch.common.constants import (
    CANONICAL_TIMESTAMP_COLUMN,
    INTERNAL_METADATA_COLUMN,
    WINDOW_END_COLUMN,
    WINDOW_START_COLUMN,
)
from denormalized_tpu_torch.common.errors import (
    DenormalizedError,
    PlanError,
    SchemaError,
    StateError,
)
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema

__all__ = [
    "CANONICAL_TIMESTAMP_COLUMN",
    "INTERNAL_METADATA_COLUMN",
    "WINDOW_END_COLUMN",
    "WINDOW_START_COLUMN",
    "DenormalizedError",
    "PlanError",
    "SchemaError",
    "StateError",
    "DataType",
    "Field",
    "Schema",
    "RecordBatch",
]
