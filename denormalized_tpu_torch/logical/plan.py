"""Logical plan nodes.

The reference reuses DataFusion's ``LogicalPlan`` and adds one extension node,
``StreamingWindowPlanNode`` (crates/core/src/logical_plan/streaming_window.rs:15)
built by ``StreamingLogicalPlanBuilder::streaming_window``
(logical_plan/mod.rs:16-60).  We own the whole (much smaller) plan algebra:
Scan / Project / Filter / StreamingWindow / Sink, each of which knows its
output schema eagerly — plan building touches no data (mirroring the lazy
construction at context.rs:65 / datastream.rs).  Counterpart of
``denormalized_tpu/logical/plan.py`` without the join nodes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Sequence

from denormalized_tpu_torch.common.constants import (
    CANONICAL_TIMESTAMP_COLUMN,
    WINDOW_END_COLUMN,
    WINDOW_START_COLUMN,
)
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical.expr import AggregateExpr, Column, Expr


class LogicalPlan:
    schema: Schema

    @property
    def children(self) -> list["LogicalPlan"]:
        return []

    def display(self, indent: int = 0) -> str:
        line = "  " * indent + self._label()
        return "\n".join([line] + [c.display(indent + 1) for c in self.children])

    def _label(self) -> str:
        return type(self).__name__


@dataclass
class Scan(LogicalPlan):
    """Leaf: a registered streaming table (reference: TopicReader registered
    by Context::from_topic, context.rs:65-72)."""

    table_name: str
    source: Any  # sources.base.Source
    schema: Schema

    def _label(self) -> str:
        return f"Scan({self.table_name})"


@dataclass
class Project(LogicalPlan):
    input: LogicalPlan
    exprs: list[Expr]
    schema: Schema

    def __init__(self, input: LogicalPlan, exprs: Sequence[Expr]):
        self.input = input
        # internal metadata columns ride along implicitly, like the struct
        # column the reference preserves through every projection.
        self.exprs = list(exprs)
        fields = [e.out_field(input.schema) for e in self.exprs]
        names = [f.name for f in fields]
        for f in input.schema:
            if f.name == CANONICAL_TIMESTAMP_COLUMN and f.name not in names:
                fields.append(f)
                self.exprs.append(Column(f.name))
        self.schema = Schema(fields)

    @property
    def children(self):
        return [self.input]

    def _label(self):
        return f"Project({', '.join(e.name for e in self.exprs)})"


@dataclass
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr
    schema: Schema = None  # type: ignore[assignment]

    def __post_init__(self):
        self.schema = self.input.schema

    @property
    def children(self):
        return [self.input]

    def _label(self):
        return f"Filter({self.predicate!r})"


class WindowType(enum.Enum):
    """Mirror of StreamingWindowType (streaming_window.rs:69-74).  Session
    windows are not ported yet: the planner refuses them."""

    TUMBLING = "tumbling"
    SLIDING = "sliding"
    SESSION = "session"


@dataclass
class StreamingWindow(LogicalPlan):
    """Windowed aggregation node (reference StreamingWindowPlanNode,
    logical_plan/streaming_window.rs:15-67; schema extension with window
    bound columns mirrors StreamingWindowSchema::try_new :83-108)."""

    input: LogicalPlan
    group_exprs: list[Expr]
    aggr_exprs: list[AggregateExpr]
    window_type: WindowType
    length_ms: int
    slide_ms: int | None  # None for tumbling; gap for session
    schema: Schema = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.length_ms <= 0:
            raise PlanError("window length must be positive")
        if self.slide_ms is not None and self.slide_ms <= 0:
            raise PlanError("window slide must be positive")
        in_schema = self.input.schema
        fields = [g.out_field(in_schema) for g in self.group_exprs]
        fields += [a.out_field(in_schema) for a in self.aggr_exprs]
        fields += [
            Field(WINDOW_START_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(WINDOW_END_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            # emitted batches carry event time (= window start) so windows
            # and joins compose downstream
            Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
        ]
        self.schema = Schema(fields)

    @property
    def children(self):
        return [self.input]

    def _label(self):
        w = f"{self.window_type.value} len={self.length_ms}ms"
        if self.slide_ms:
            w += f" slide={self.slide_ms}ms"
        return (
            f"StreamingWindow([{', '.join(g.name for g in self.group_exprs)}] "
            f"[{', '.join(a.name for a in self.aggr_exprs)}] {w})"
        )


@dataclass
class Sink(LogicalPlan):
    """Terminal node: stdout print / python callback / kafka topic writer
    (reference datastream.rs print_stream :311 / sink_kafka :346;
    py sink_python datastream.rs(py):229)."""

    input: LogicalPlan
    sink: Any  # physical.sinks.Sink factory
    schema: Schema = None  # type: ignore[assignment]

    def __post_init__(self):
        self.schema = self.input.schema

    @property
    def children(self):
        return [self.input]

    def _label(self):
        return f"Sink({type(self.sink).__name__})"
