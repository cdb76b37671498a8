"""Bounded CSV source (the reference's csv_streaming.rs sanity path:
plain DataFusion CSV → window → output).

Copy of ``denormalized_tpu/sources/csv.py`` for the port: the same schema
inference and parsing, with string columns built as ``StringColumn``s
(``common/columns.py``, the port's always-columnar strings) instead of
object arrays; an empty field is null, as there."""

from __future__ import annotations

import csv as _csv

import numpy as np

from denormalized_tpu_torch.common.columns import StringColumn
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.sources.memory import MemorySource


def infer_csv_schema(path: str, sample_rows: int = 100) -> Schema:
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise SourceError(f"CSV {path!r} is empty (no header line)") from None
        samples = [row for _, row in zip(range(sample_rows), reader)]
    fields = []
    for ci, name in enumerate(header):
        vals = [r[ci] for r in samples if ci < len(r) and r[ci] != ""]
        fields.append(Field(name, _infer(vals)))
    return Schema(fields)


def _infer(vals: list[str]) -> DataType:
    if not vals:
        return DataType.STRING
    try:
        ints = [int(v) for v in vals]
        return DataType.INT64
    except ValueError:
        pass
    try:
        [float(v) for v in vals]
        return DataType.FLOAT64
    except ValueError:
        pass
    lowered = {v.lower() for v in vals}
    if lowered <= {"true", "false"}:
        return DataType.BOOL
    return DataType.STRING


def _string_column(raw: list[str], mask: np.ndarray) -> StringColumn:
    """One chunk's text fields as a StringColumn: offsets into their
    UTF-8 bytes, null where the field was empty."""
    parts = [v.encode() for v in raw]
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    data = np.frombuffer(b"".join(parts), dtype=np.uint8)
    return StringColumn(offsets, data, None if mask.all() else mask)


class CsvSource(MemorySource):
    def __init__(
        self,
        path: str,
        schema: Schema | None = None,
        timestamp_column: str | None = None,
        batch_rows: int = 8192,
        timestamp_unit: str = "ms",
    ):
        schema = schema or infer_csv_schema(path)
        batches = []
        with open(path, newline="") as f:
            reader = _csv.reader(f)
            try:
                header = next(reader)
            except StopIteration:
                raise SourceError(
                    f"CSV {path!r} is empty (no header line)"
                ) from None
            idx = {}
            for field in schema:
                if field.name not in header:
                    raise SourceError(f"CSV missing column {field.name!r}")
                idx[field.name] = header.index(field.name)
            rows = list(reader)
        for start in range(0, len(rows), batch_rows):
            chunk = rows[start : start + batch_rows]
            cols, masks = [], []
            for field in schema:
                ci = idx[field.name]
                raw = [r[ci] if ci < len(r) else "" for r in chunk]
                mask = np.array([v != "" for v in raw])
                if field.dtype is DataType.STRING:
                    col = _string_column(raw, mask)
                elif field.dtype is DataType.BOOL:
                    col = np.array([v.lower() == "true" for v in raw])
                else:
                    npdt = field.dtype.to_numpy()
                    try:
                        col = np.array(
                            [
                                npdt.type(v) if v != "" else npdt.type(0)
                                for v in raw
                            ],
                            dtype=npdt,
                        )
                    except (ValueError, OverflowError) as e:
                        # value outside the inferred sample's type (schema
                        # was inferred from the first rows only)
                        raise SourceError(
                            f"CSV column {field.name!r} near row {start}: "
                            f"{e}; pass an explicit schema to CsvSource"
                        ) from None
                cols.append(col)
                masks.append(None if mask.all() else mask)
            batches.append(RecordBatch(schema, cols, masks))
        if not batches:
            batches = [RecordBatch.empty(schema)]
        super().__init__(
            [batches], timestamp_column, name=path,
            timestamp_unit=timestamp_unit,
        )
