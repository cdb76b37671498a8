"""Physical operator protocol — counterpart of
``denormalized_tpu/physical/base.py`` without the observability, doctor and
state-observatory hooks.

The physical layer is a pull-based pipeline of Python generators flowing
:class:`StreamItem`s:

- ``RecordBatch`` — data;
- :class:`Marker` — an in-band checkpoint barrier: each stateful operator
  snapshots when it passes, and the executor commits the epoch when it
  reaches the root;
- :class:`WatermarkHint` — an event-time advance that does not ride a
  batch: a join's clamped joint watermark, or an idle source's one-shot;
- :class:`EndOfStream` — bounded input exhausted (replay/test sources); the
  windowed operator flushes open windows on receipt.

Heavy compute happens inside operators (device steps in the window exec);
the generator plumbing between them moves only batch references.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Union

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema


@dataclass(frozen=True)
class WatermarkHint:
    """Event-time advance that does not ride a batch.  Two kinds:

    - ``"idle"`` — advisory one-shot: no further rows at or before
      ``ts_ms`` are expected, so stateful operators may close windows up
      to it;
    - ``"partition"`` — AUTHORITATIVE watermark: operators that see one
      stop advancing their watermark from raw batch min-ts.  The join
      announces this mode before its first output and then emits its
      clamped joint watermark, since a joined row can be as old as the
      eviction horizon.  A hint with ``ts_ms <= WM_ANNOUNCE`` is a pure
      mode announcement carrying no timestamp.

    Stateless operators pass both kinds through; the sink and the root
    loops skip them."""

    ts_ms: int
    kind: str = "idle"

    @property
    def is_announcement(self) -> bool:
        """Pure mode announcement: switches operators to hint-driven
        watermarks without advancing anything.  Every stateful operator
        uses THIS check, so the rule cannot drift between call sites."""
        return self.ts_ms <= WM_ANNOUNCE


#: mode-announcement sentinel: a kind="partition" hint at or below this
#: value switches operators to hint-driven watermarks without advancing
#: anything
WM_ANNOUNCE = -(2**62)


@dataclass(frozen=True)
class Marker:
    """Checkpoint barrier of epoch ``epoch`` (reference
    OrchestrationMessage::CheckpointBarrier, orchestrator.rs:12-16)."""

    epoch: int


@dataclass(frozen=True)
class EndOfStream:
    pass


EOS = EndOfStream()

StreamItem = Union[RecordBatch, Marker, WatermarkHint, EndOfStream]


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
