"""Physical operator protocol — counterpart of
``denormalized_tpu/physical/base.py`` without the observability, doctor and
state-observatory hooks.

The physical layer is a pull-based pipeline of Python generators flowing
:class:`StreamItem`s:

- ``RecordBatch`` — data;
- :class:`Marker` — an in-band checkpoint barrier: each stateful operator
  snapshots when it passes, and the executor commits the epoch when it
  reaches the root;
- :class:`EndOfStream` — bounded input exhausted (replay/test sources); the
  windowed operator flushes open windows on receipt.

Heavy compute happens inside operators (device steps in the window exec);
the generator plumbing between them moves only batch references.
Watermark hints are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Union

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema


@dataclass(frozen=True)
class Marker:
    """Checkpoint barrier of epoch ``epoch`` (reference
    OrchestrationMessage::CheckpointBarrier, orchestrator.rs:12-16)."""

    epoch: int


@dataclass(frozen=True)
class EndOfStream:
    pass


EOS = EndOfStream()

StreamItem = Union[RecordBatch, Marker, EndOfStream]


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
