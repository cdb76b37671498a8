"""Physical operator protocol — counterpart of
``denormalized_tpu/physical/base.py`` without the observability, doctor and
state-observatory hooks.

The physical layer is a pull-based pipeline of Python generators flowing
:class:`StreamItem`s:

- ``RecordBatch`` — data;
- :class:`EndOfStream` — bounded input exhausted (replay/test sources); the
  windowed operator flushes open windows on receipt.

Heavy compute happens inside operators (device steps in the window exec);
the generator plumbing between them moves only batch references.
Checkpoint markers and watermark hints are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Union

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema


@dataclass(frozen=True)
class EndOfStream:
    pass


EOS = EndOfStream()

StreamItem = Union[RecordBatch, EndOfStream]


class ExecOperator:
    """One node of the physical plan."""

    #: output schema
    schema: Schema

    def run(self) -> Iterator[StreamItem]:
        raise NotImplementedError

    @property
    def children(self) -> list["ExecOperator"]:
        return []

    def metrics(self) -> dict[str, float]:
        return {}
