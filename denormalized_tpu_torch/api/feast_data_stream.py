"""Feast feature-store integration.

Mirror of the reference's ``FeastDataStream``
(py-denormalized/python/denormalized/feast_data_stream.py:19-123): a
DataStream whose transform methods keep returning FeastDataStream (the
reference does this with a metaclass rewriting DataStream-returning
methods), plus ``write_feast_feature`` pushing each emitted batch to a Feast
push source.  Feast itself is an optional dependency — any object with
``push(push_source_name, df)`` works (tests use a fake store).

Copy of ``denormalized_tpu/api/feast_data_stream.py`` for the port.
"""

from __future__ import annotations

from typing import Any

from denormalized_tpu_torch.api.data_stream import DataStream


class _FeastMeta(type):
    """Rewrap DataStream-returning methods so chaining stays Feast-typed
    (the reference's metaclass trick)."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        for attr in (
            "select",
            "select_columns",
            "filter",
            "with_column",
            "with_column_renamed",
            "drop_columns",
            "window",
            "session_window",
            "join",
            "join_on",
        ):
            base_fn = getattr(DataStream, attr)

            def wrapped(self, *a, __fn=base_fn, **kw):
                out = __fn(self, *a, **kw)
                return (
                    FeastDataStream(out._plan, out._ctx)
                    if isinstance(out, DataStream)
                    else out
                )

            setattr(cls, attr, wrapped)
        return cls


class FeastDataStream(DataStream, metaclass=_FeastMeta):
    @classmethod
    def from_data_stream(cls, ds: DataStream) -> "FeastDataStream":
        return cls(ds._plan, ds._ctx)

    def write_feast_feature(
        self, feature_store: Any, push_source_name: str
    ) -> None:
        """Execute the stream, pushing each batch to the feature store
        (reference feast_data_stream.py write_feast_feature)."""

        def push(batch):
            rows = {
                f.name: batch.column(f.name)
                for f in batch.schema.without_internal()
            }
            df = _to_frame(rows)
            feature_store.push(push_source_name, df)

        self.sink(push)


def _to_frame(rows: dict):
    """Feast expects a pandas DataFrame; fall back to the dict when pandas
    is unavailable (fake stores in tests accept both)."""
    try:
        import pandas as pd

        return pd.DataFrame(rows)
    except ImportError:
        return rows
