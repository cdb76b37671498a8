"""Columnar schema model.

The reference leans on Arrow's schema (DataTypes used across
crates/core/src/utils/arrow_helpers.rs and the decoders).  We keep a small,
device-oriented type lattice: every type knows its host (numpy)
representation and whether it can live on device.  Strings are host-only —
group keys are interned to dense int32 ids before touching the device (the
analog of DataFusion's ``GroupValues`` interning table used at
grouped_window_agg_stream.rs:501-537).  Copy of
``denormalized_tpu/common/schema.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np

from denormalized_tpu_torch.common.errors import SchemaError


class DataType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    STRING = "string"
    # milliseconds since unix epoch, int64 storage (arrow timestamp-millis
    # equivalent; the reference's canonical_timestamp type,
    # kafka_config.rs:203-208)
    TIMESTAMP_MS = "timestamp_ms"
    # nested struct — host-only, used for nested JSON (rideshare example)
    STRUCT = "struct"
    # variable-length list — host-only (object array of np arrays / lists)
    LIST = "list"

    def to_numpy(self) -> np.dtype:
        return _NUMPY_OF[self]

    @property
    def is_numeric(self) -> bool:
        return self in (
            DataType.INT32,
            DataType.INT64,
            DataType.FLOAT32,
            DataType.FLOAT64,
            DataType.TIMESTAMP_MS,
            DataType.BOOL,
        )

    @property
    def device_ok(self) -> bool:
        """Whether a column of this type can be shipped to the device directly."""
        return self.is_numeric

    @staticmethod
    def from_numpy(dt: np.dtype) -> "DataType":
        dt = np.dtype(dt)
        if dt == np.int32:
            return DataType.INT32
        if dt in (np.int64, np.dtype("datetime64[ms]")):
            return DataType.INT64
        if dt == np.float32:
            return DataType.FLOAT32
        if dt == np.float64:
            return DataType.FLOAT64
        if dt == np.bool_:
            return DataType.BOOL
        if dt.kind in ("U", "S", "O"):
            return DataType.STRING
        raise SchemaError(f"unsupported numpy dtype {dt!r}")


_NUMPY_OF = {
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FLOAT32: np.dtype(np.float32),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.BOOL: np.dtype(np.bool_),
    DataType.STRING: np.dtype(object),
    DataType.TIMESTAMP_MS: np.dtype(np.int64),
    DataType.STRUCT: np.dtype(object),
    DataType.LIST: np.dtype(object),
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    # for STRUCT fields: child fields
    children: tuple["Field", ...] = ()

    def __post_init__(self):
        # accept the enum's string value ("int64", "string", …) — failing
        # here with the valid names beats an AttributeError deep in an
        # operator long after schema construction
        if isinstance(self.dtype, str):
            try:
                object.__setattr__(self, "dtype", DataType(self.dtype))
            except ValueError:
                raise ValueError(
                    f"unknown dtype {self.dtype!r} for field "
                    f"{self.name!r}; expected one of "
                    f"{[d.value for d in DataType]}"
                ) from None

    def __repr__(self) -> str:
        if self.dtype is DataType.STRUCT:
            return f"Field({self.name}: struct<{', '.join(map(repr, self.children))}>)"
        return f"Field({self.name}: {self.dtype.value})"


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise SchemaError(f"duplicate column names: {dupes}")

    # -- lookups ---------------------------------------------------------
    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise SchemaError(
            f"column {name!r} not found; available: {[f.name for f in self.fields]}"
        )

    def has(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise SchemaError(f"column {name!r} not found")

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def __iter__(self) -> Iterator[Field]:
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    # -- transforms ------------------------------------------------------
    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def drop(self, names: Sequence[str]) -> "Schema":
        gone = set(names)
        return Schema([f for f in self.fields if f.name not in gone])

    def append(self, *fields: Field) -> "Schema":
        return Schema(list(self.fields) + list(fields))

    def rename(self, mapping: dict[str, str]) -> "Schema":
        return Schema(
            [
                Field(mapping.get(f.name, f.name), f.dtype, f.nullable, f.children)
                for f in self.fields
            ]
        )

    def without_internal(self) -> "Schema":
        """User-visible schema: strips internal metadata columns (mirrors
        DataStream::schema, reference datastream.rs:199-210)."""
        from denormalized_tpu_torch.common.constants import (
            CANONICAL_TIMESTAMP_COLUMN,
            INTERNAL_METADATA_COLUMN,
        )

        return Schema(
            [
                f
                for f in self.fields
                if f.name != CANONICAL_TIMESTAMP_COLUMN
                and not f.name.startswith(INTERNAL_METADATA_COLUMN)
            ]
        )

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(repr(f) for f in self.fields) + ")"
