"""Columnar record batch: a schema plus one host (numpy) array per column.

The host-side unit of flow between physical operators, playing the role of
Arrow ``RecordBatch`` in the reference.  Device transfer happens only inside
the windowed-aggregation operator, which ships the numeric columns it needs
as padded tensors — batches themselves never hold device tensors.

Counterpart of ``denormalized_tpu/common/record_batch.py``: a column is a
numpy array or an Arrow-layout :class:`~denormalized_tpu_torch.common.
columns.Column` (strings from the JSON parser stay ``StringColumn``s), with
the constructors and transforms the window, join and Kafka paths use and
``to_pyarrow`` for ``sink(as_pyarrow=True)``.

Nullability: a column may carry a boolean validity mask; ``None`` mask means
all-valid (Arrow's convention).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from denormalized_tpu_torch.common.columns import (
    Column,
    as_numpy,
    concat_columns,
)
from denormalized_tpu_torch.common.errors import SchemaError
from denormalized_tpu_torch.common.schema import DataType, Field, Schema


@dataclass
class RecordBatch:
    schema: Schema
    # plain host ndarrays, or columnar Column instances (StringColumn /
    # NestedColumn — see common/columns.py) for string & nested fields
    columns: list[np.ndarray]
    # validity masks, parallel to columns; None = all valid
    masks: list[np.ndarray | None]
    num_rows: int

    def __init__(
        self,
        schema: Schema,
        columns: Sequence[np.ndarray],
        masks: Sequence[np.ndarray | None] | None = None,
    ):
        if len(columns) != len(schema):
            raise SchemaError(
                f"{len(columns)} columns for schema of {len(schema)} fields"
            )
        self.schema = schema
        self.columns = [
            c if isinstance(c, Column) else np.asarray(c) for c in columns
        ]
        n = self.columns[0].shape[0] if self.columns else 0
        for f, c in zip(schema, self.columns):
            if c.shape[0] != n:
                raise SchemaError(
                    f"column {f.name!r} has {c.shape[0]} rows, expected {n}"
                )
        self.masks = list(masks) if masks is not None else [None] * len(self.columns)
        if len(self.masks) != len(self.columns):
            raise SchemaError("masks length != columns length")
        self.num_rows = n

    # -- constructors ----------------------------------------------------
    @staticmethod
    def empty(schema: Schema) -> "RecordBatch":
        return RecordBatch(
            schema, [np.empty(0, dtype=f.dtype.to_numpy()) for f in schema]
        )

    # -- access ----------------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        return self.columns[self.schema.index_of(name)]

    def mask(self, name: str) -> np.ndarray | None:
        return self.masks[self.schema.index_of(name)]

    def to_pydict(self) -> dict[str, list]:
        """Python value lists per column, with validity APPLIED: a null
        entry surfaces as ``None``, never as the storage fill value."""
        out: dict[str, list] = {}
        for f, c, m in zip(self.schema, self.columns, self.masks):
            vals = c.tolist()
            if m is not None and not (valid := np.asarray(m, dtype=bool)).all():
                vals = [
                    v if ok else None for v, ok in zip(vals, valid.tolist())
                ]
            out[f.name] = vals
        return out

    def materialized(self) -> "RecordBatch":
        """A batch whose columnar string/nested columns are replaced by
        their object-array materialization — the user-facing boundary
        (CallbackSink, UDF inputs).  A batch with no Column instances
        returns itself."""
        if not any(isinstance(c, Column) for c in self.columns):
            return self
        return RecordBatch(
            self.schema, [as_numpy(c) for c in self.columns], self.masks
        )

    def to_pyarrow(self):
        """Convert to a ``pyarrow.RecordBatch`` (nulls preserved)."""
        import pyarrow as pa

        arrays, fields = [], []
        for f, col, mask in zip(self.schema, self.columns, self.masks):
            nulls = None if mask is None else ~np.asarray(mask, dtype=bool)
            pa_type = _pa_type_of_field(pa, f)
            if pa_type is not None and col.dtype != object and not (
                pa.types.is_struct(pa_type) or pa.types.is_list(pa_type)
            ):
                arr = pa.array(np.ascontiguousarray(col), type=pa_type,
                               mask=nulls)
            else:
                # strings and host-only STRUCT/LIST columns go through
                # python values; nulls become None.  The declared type
                # keeps the arrow schema identical between empty and
                # non-empty batches
                vals = col.tolist()
                if nulls is not None:
                    vals = [None if d else v for v, d in zip(vals, nulls)]
                arr = (pa.array(vals, type=pa_type)
                       if pa_type is not None else pa.array(vals))
            arrays.append(arr)
            fields.append(pa.field(f.name, arr.type, nullable=f.nullable))
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    # -- transforms ------------------------------------------------------
    def select(self, names: Sequence[str]) -> "RecordBatch":
        idx = [self.schema.index_of(n) for n in names]
        return RecordBatch(
            self.schema.select(names),
            [self.columns[i] for i in idx],
            [self.masks[i] for i in idx],
        )

    def with_column(
        self, field: Field, col: np.ndarray, mask: np.ndarray | None = None
    ) -> "RecordBatch":
        """Append or replace a column."""
        if self.schema.has(field.name):
            i = self.schema.index_of(field.name)
            fields = list(self.schema.fields)
            fields[i] = field
            cols = list(self.columns)
            cols[i] = col if isinstance(col, Column) else np.asarray(col)
            masks = list(self.masks)
            masks[i] = mask
            return RecordBatch(Schema(fields), cols, masks)
        return RecordBatch(
            self.schema.append(field),
            list(self.columns)
            + [col if isinstance(col, Column) else np.asarray(col)],
            list(self.masks) + [mask],
        )

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch(
            self.schema,
            [c[indices] for c in self.columns],
            [m[indices] if m is not None else None for m in self.masks],
        )

    def filter(self, keep: np.ndarray) -> "RecordBatch":
        keep = np.asarray(keep, dtype=bool)
        return RecordBatch(
            self.schema,
            [c[keep] for c in self.columns],
            [m[keep] if m is not None else None for m in self.masks],
        )

    def slice(self, start: int, length: int) -> "RecordBatch":
        return RecordBatch(
            self.schema,
            [c[start : start + length] for c in self.columns],
            [m[start : start + length] if m is not None else None for m in self.masks],
        )

    @staticmethod
    def concat(
        batches: Sequence["RecordBatch"], schema: Schema | None = None
    ) -> "RecordBatch":
        batches = list(batches)
        if not batches:
            if schema is None:
                raise SchemaError(
                    "RecordBatch.concat of an empty sequence needs an "
                    "explicit schema= argument"
                )
            return RecordBatch.empty(schema)
        batches = [b for b in batches if b.num_rows > 0] or batches[:1]
        first = batches[0]
        cols = [
            concat_columns([b.columns[i] for b in batches])
            for i in range(len(first.schema))
        ]
        masks = []
        for i in range(len(first.schema)):
            if any(b.masks[i] is not None for b in batches):
                masks.append(
                    np.concatenate(
                        [
                            b.masks[i]
                            if b.masks[i] is not None
                            else np.ones(b.num_rows, dtype=bool)
                            for b in batches
                        ]
                    )
                )
            else:
                masks.append(None)
        return RecordBatch(first.schema, cols, masks)

    def __repr__(self) -> str:
        return f"RecordBatch({self.num_rows} rows, {self.schema!r})"



# engine dtype → pyarrow type factory (callables taking the pa module, so
# pyarrow stays a lazy import); STRUCT/LIST fall through to inference
_PA_OF = {
    DataType.INT32: lambda pa: pa.int32(),
    DataType.INT64: lambda pa: pa.int64(),
    DataType.FLOAT32: lambda pa: pa.float32(),
    DataType.FLOAT64: lambda pa: pa.float64(),
    DataType.BOOL: lambda pa: pa.bool_(),
    DataType.STRING: lambda pa: pa.string(),
    DataType.TIMESTAMP_MS: lambda pa: pa.timestamp("ms"),
}


def _pa_type_of_field(pa, f):
    """Arrow type for an engine Field, or None when not derivable (a LIST
    with no declared child falls back to value inference)."""
    base = _PA_OF.get(f.dtype)
    if base is not None:
        return base(pa)
    if f.dtype is DataType.STRUCT:
        return pa.struct(
            [
                pa.field(c.name, _pa_type_of_field(pa, c) or pa.null(),
                         nullable=c.nullable)
                for c in f.children
            ]
        )
    if f.dtype is DataType.LIST and len(f.children) == 1:
        child = _pa_type_of_field(pa, f.children[0])
        if child is not None:
            return pa.list_(child)
    return None
