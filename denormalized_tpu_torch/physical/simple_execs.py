"""Source / projection / filter / sink operators (host-side, vectorized).

Counterpart of ``denormalized_tpu/physical/simple_execs.py`` for bounded
sources: the source round-robins its partitions in-thread, injects a
checkpoint :class:`Marker` after the batch during which a barrier arrived
(persisting the offsets of the batches it has yielded), and ends with
EndOfStream.  Idle and per-partition watermarks, the cluster barrier hooks
and the prefetch pump of live sources are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical.expr import AliasExpr, Column, Expr
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
)
from denormalized_tpu_torch.sources.base import Source


class SourceExec(ExecOperator):
    """Leaf operator: drives every partition of a bounded source
    round-robin and merges their batches into one ordered stream."""

    def __init__(self, source: Source) -> None:
        self.source = source
        self.schema = source.schema
        self._barrier_poll: Callable[[], int | None] | None = None
        self._ckpt = None  # (CheckpointCoordinator, node_id)
        # per partition, the offset snapshot after its last YIELDED batch
        self._yielded_offsets: list | None = None

    # -- checkpointing (offset persistence mirrors BatchReadMetadata,
    # kafka_stream_read.rs:49-65,275-289; restore :110-140) -------------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        from denormalized_tpu_torch.state.checkpoint import make_barrier_poll

        self._ckpt = (coord, node_id)
        base_poll = make_barrier_poll(orch.register(f"src_{node_id}"))

        def poll():
            epoch = base_poll()
            if epoch is not None:
                self._persist_offsets(epoch)
            return epoch

        self._barrier_poll = poll

    def _persist_offsets(self, epoch: int) -> None:
        from denormalized_tpu_torch.state.checkpoint import put_json

        if self._ckpt is None or self._yielded_offsets is None:
            return
        coord, node_id = self._ckpt
        put_json(
            coord,
            f"offsets_{node_id}",
            epoch,
            {"epoch": epoch, "partitions": list(self._yielded_offsets)},
        )

    def _restore_offsets(self, readers) -> None:
        from denormalized_tpu_torch.common.errors import StateError
        from denormalized_tpu_torch.state.checkpoint import get_json

        if self._ckpt is None:
            return
        coord, node_id = self._ckpt
        snap = get_json(coord, f"offsets_{node_id}")
        if snap is None:
            return
        parts = snap.get("partitions", [])
        if len(parts) != len(readers):
            raise StateError(
                f"checkpoint has {len(parts)} partitions but source "
                f"{self.source.name!r} now has {len(readers)} — partition "
                "layout must match across restarts"
            )
        for r, s in zip(readers, parts):
            r.offset_restore(s)

    def run(self) -> Iterator[StreamItem]:
        if self.source.unbounded:
            from denormalized_tpu_torch.common.errors import PlanError

            raise PlanError(
                "unbounded sources not yet ported to denormalized_tpu_torch"
            )
        readers = self.source.partitions()
        poll = self._barrier_poll
        if poll is not None:
            self._restore_offsets(readers)
            self._yielded_offsets = [r.offset_snapshot() for r in readers]
        live = list(enumerate(readers))
        while live:
            nxt = []
            for i, r in live:
                b = r.read()
                if b is None:
                    continue
                nxt.append((i, r))
                if b.num_rows:
                    yield b
                    if poll is not None:
                        self._yielded_offsets[i] = r.offset_snapshot()
                if poll is not None:
                    epoch = poll()
                    if epoch is not None:
                        yield Marker(epoch)
            live = nxt
        yield EOS


class ProjectExec(ExecOperator):
    def __init__(self, input_op: ExecOperator, exprs: list[Expr], schema: Schema):
        self.input_op = input_op
        self.exprs = exprs
        self.schema = schema

    @property
    def children(self):
        return [self.input_op]


    def run(self) -> Iterator[StreamItem]:
        def passthrough_name(e: Expr) -> str | None:
            # validity masks survive projections that are pure column
            # references (possibly aliased); computed exprs get no mask
            while isinstance(e, AliasExpr):
                e = e.inner
            return e.name if isinstance(e, Column) else None

        for item in self.input_op.run():
            if isinstance(item, RecordBatch):
                cols = [e.eval(item) for e in self.exprs]
                masks = [
                    item.mask(src) if (src := passthrough_name(e)) is not None else None
                    for e in self.exprs
                ]
                yield RecordBatch(self.schema, cols, masks)
            else:
                yield item


class FilterExec(ExecOperator):
    def __init__(self, input_op: ExecOperator, predicate: Expr):
        self.input_op = input_op
        self.predicate = predicate
        self.schema = input_op.schema

    @property
    def children(self):
        return [self.input_op]


    def run(self) -> Iterator[StreamItem]:
        for item in self.input_op.run():
            if isinstance(item, RecordBatch):
                keep = np.asarray(self.predicate.eval(item), dtype=bool)
                if keep.all():
                    yield item
                elif keep.any():
                    yield item.filter(keep)
            else:
                yield item


class SinkExec(ExecOperator):
    """Terminal operator driving a sink over the finished stream."""

    def __init__(self, input_op: ExecOperator, sink: "Sink") -> None:
        self.input_op = input_op
        self.sink = sink
        self.schema = input_op.schema

    @property
    def children(self):
        return [self.input_op]


    def run(self) -> Iterator[StreamItem]:
        for item in self.input_op.run():
            if isinstance(item, RecordBatch):
                self.sink.write(item)
            elif isinstance(item, EndOfStream):
                self.sink.close()
            yield item


class Sink:
    def write(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CollectSink(Sink):
    """Collects emitted batches."""

    def __init__(self) -> None:
        self.batches: list[RecordBatch] = []

    def write(self, batch: RecordBatch) -> None:
        self.batches.append(batch)

    def result(self) -> RecordBatch:
        return RecordBatch.concat(self.batches)
