"""Columnar record batch: a schema plus one host (numpy) array per column.

The host-side unit of flow between physical operators, playing the role of
Arrow ``RecordBatch`` in the reference.  Device transfer happens only inside
the windowed-aggregation operator, which ships the numeric columns it needs
as padded tensors — batches themselves never hold device tensors.

Counterpart of ``denormalized_tpu/common/record_batch.py``, trimmed to plain
numpy columns: strings are object arrays (the Arrow-layout
``common/columns.py`` is not ported yet), with the constructors and
transforms the window and join paths use.

Nullability: a column may carry a boolean validity mask; ``None`` mask means
all-valid (Arrow's convention).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from denormalized_tpu_torch.common.errors import SchemaError
from denormalized_tpu_torch.common.schema import Field, Schema


@dataclass
class RecordBatch:
    schema: Schema
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
        self.columns = [np.asarray(c) for c in columns]
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

    # -- transforms ------------------------------------------------------
    def with_column(
        self, field: Field, col: np.ndarray, mask: np.ndarray | None = None
    ) -> "RecordBatch":
        """Append or replace a column."""
        if self.schema.has(field.name):
            i = self.schema.index_of(field.name)
            fields = list(self.schema.fields)
            fields[i] = field
            cols = list(self.columns)
            cols[i] = np.asarray(col)
            masks = list(self.masks)
            masks[i] = mask
            return RecordBatch(Schema(fields), cols, masks)
        return RecordBatch(
            self.schema.append(field),
            list(self.columns) + [np.asarray(col)],
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
            np.concatenate([b.columns[i] for b in batches])
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

