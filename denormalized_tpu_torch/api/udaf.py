"""User-defined aggregate functions.

Mirrors the reference's Python UDAF surface: users subclass ``Accumulator``
(py-denormalized python/denormalized/datafusion/udf.py; example stateful
accumulator at python/examples/udaf_example.py) with
update/merge/state/evaluate methods over numpy arrays instead of pyarrow.

Copy of ``denormalized_tpu/api/udaf.py`` for the port.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from denormalized_tpu_torch.common.schema import DataType


class Accumulator:
    """Stateful aggregate over one group within one window.

    Methods mirror datafusion-python's Accumulator protocol:
    - ``update(*columns)``: fold in a chunk of argument columns (numpy arrays)
    - ``merge(states)``: fold in another accumulator's ``state()`` output
    - ``state()``: serializable partial-aggregation state (list of values)
    - ``evaluate()``: final result
    """

    def update(self, *columns: np.ndarray) -> None:
        raise NotImplementedError

    def merge(self, states: Sequence) -> None:
        raise NotImplementedError

    def state(self) -> list:
        raise NotImplementedError

    def evaluate(self) -> Any:
        raise NotImplementedError


class UDAF:
    """Descriptor binding an Accumulator class to argument expressions.
    ``return_type=None`` means "same type as the first argument" (used by
    first_value/last_value, which are type-preserving like DataFusion's)."""

    def __init__(
        self, accumulator_cls, args, return_type: DataType | None, name: str
    ):
        self.accumulator_cls = accumulator_cls
        self.args = args  # tuple[Expr, ...]
        self.return_type = return_type
        self.name = name

    def make(self) -> Accumulator:
        return self.accumulator_cls()
