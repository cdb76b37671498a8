"""Source / projection / filter / sink operators (host-side, vectorized).

Counterpart of ``denormalized_tpu/physical/simple_execs.py`` for bounded
sources: the source round-robins its partitions in-thread and ends with
EndOfStream.  Idle and per-partition watermarks, barriers and the prefetch
pump of live sources are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical.expr import AliasExpr, Column, Expr
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    StreamItem,
)
from denormalized_tpu_torch.sources.base import Source


class SourceExec(ExecOperator):
    """Leaf operator: drives every partition of a bounded source
    round-robin and merges their batches into one ordered stream."""

    def __init__(self, source: Source) -> None:
        self.source = source
        self.schema = source.schema


    def run(self) -> Iterator[StreamItem]:
        if self.source.unbounded:
            from denormalized_tpu_torch.common.errors import PlanError

            raise PlanError(
                "unbounded sources not yet ported to denormalized_tpu_torch"
            )
        live = list(self.source.partitions())
        while live:
            nxt = []
            for r in live:
                b = r.read()
                if b is None:
                    continue
                nxt.append(r)
                if b.num_rows:
                    yield b
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
