"""Logical plan nodes.

The reference reuses DataFusion's ``LogicalPlan`` and adds one extension node,
``StreamingWindowPlanNode`` (crates/core/src/logical_plan/streaming_window.rs:15)
built by ``StreamingLogicalPlanBuilder::streaming_window``
(logical_plan/mod.rs:16-60).  We own the whole (much smaller) plan algebra:
Scan / Project / Filter / StreamingWindow / Join / Sink, each of which knows
its output schema eagerly — plan building touches no data (mirroring the
lazy construction at context.rs:65 / datastream.rs).  Counterpart of
``denormalized_tpu/logical/plan.py``.
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
    windows are declared-but-unimplemented in the reference (`todo!()`);
    the session-window operator implements them."""

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


class JoinKind(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    # existence joins (DataFusion JoinType::LeftSemi/LeftAnti, exposed by
    # the reference's DataStream::join surface, datastream.rs:129): output
    # is LEFT rows only — semi emits each left row at most once when a
    # right match exists; anti emits left rows proven matchless (at
    # eviction horizon or EOS).  Right-side variants normalize to these by
    # swapping inputs at the API layer (DataStream.join).
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"


@dataclass(frozen=True)
class JoinBand:
    """Banded (interval/range) join predicate riding alongside the equi
    keys: a pair matches iff ``left_expr - right_expr`` lands in
    ``[lower_ms, upper_ms]`` (inclusive; ``None`` = unbounded on that
    side).  ``lower_ms > upper_ms`` is a legal EMPTY band (matches
    nothing).  Each expression is evaluated against its OWN input's
    schema, so a band can reference the right side's canonical timestamp
    even though that column never appears in the join output — the
    enrichment/temporal-correlation shape (``ts BETWEEN a AND b``) the
    residual pair filter cannot express.  Rows only match while
    co-retained: a band reaching beyond ``join_retention_ms`` is clipped
    by eviction.  The join operator refuses a band with no bound."""

    left_expr: Expr
    right_expr: Expr
    lower_ms: int | float | None
    upper_ms: int | float | None

    def _label(self) -> str:
        lo = "-inf" if self.lower_ms is None else self.lower_ms
        hi = "+inf" if self.upper_ms is None else self.upper_ms
        return (
            f"{self.left_expr.name} - {self.right_expr.name} in "
            f"[{lo}, {hi}]"
        )


@dataclass
class Join(LogicalPlan):
    """Stream-stream equi-join.  The reference lowers joins to DataFusion's
    join over two windowed streams (datastream.rs:126-177); ours is a
    symmetric streaming hash join keyed on the equi-columns."""

    left: LogicalPlan
    right: LogicalPlan
    kind: JoinKind
    left_keys: list[str]
    right_keys: list[str]
    filter: Expr | None = None
    band: JoinBand | None = None
    schema: Schema = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.kind in (JoinKind.LEFT_SEMI, JoinKind.LEFT_ANTI):
            # existence joins surface no right columns, so same-named
            # columns across sides are fine in the OUTPUT — but a join
            # filter still evaluates over matched pairs, and a name both
            # sides carry would silently bind to the left column there
            if self.filter is not None:
                shared_keys = {
                    l for l, r in zip(self.left_keys, self.right_keys)
                    if l == r
                }  # equal by construction on a matched pair: unambiguous
                both = (
                    {f.name for f in self.left.schema}
                    & {f.name for f in self.right.schema}
                ) - shared_keys - {CANONICAL_TIMESTAMP_COLUMN}
                amb = self.filter.columns_referenced() & both
                if amb:
                    raise PlanError(
                        f"ambiguous column(s) {sorted(amb)} in "
                        f"{self.kind.value} join filter: present on both "
                        "sides; rename one side before joining"
                    )
            self.schema = self.left.schema
            return
        fields = list(self.left.schema.fields)
        names = {f.name for f in fields}
        for f in self.right.schema:
            if f.name == CANONICAL_TIMESTAMP_COLUMN:
                continue  # keep left's canonical timestamp
            if f.name in names:
                if f.name in self.right_keys and f.name in self.left_keys:
                    continue  # shared equi-key appears once
                raise PlanError(
                    f"ambiguous column {f.name!r} in join; rename one side "
                    "(reference renames via with_column before joining)"
                )
            fields.append(f)
        self.schema = Schema(fields)

    @property
    def children(self):
        return [self.left, self.right]

    def _label(self):
        on = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys))
        if self.band is not None:
            on += f", band {self.band._label()}"
        return f"Join({self.kind.value} on {on})"


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
