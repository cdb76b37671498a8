"""DataStream — the fluent user API.

Counterpart of ``denormalized_tpu/api/data_stream.py`` with the methods the
window job uses: select / filter / window, and collect / stream to run it.
Plan building is lazy; execution happens in collect and stream.
"""

from __future__ import annotations

from typing import Iterator, Sequence

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.expr import AggregateExpr, Expr, col


class DataStream:
    def __init__(self, plan: lp.LogicalPlan, ctx) -> None:
        self._plan = plan
        self._ctx = ctx

    def schema(self) -> Schema:
        """User-visible schema (internal metadata stripped)."""
        return self._plan.schema.without_internal()

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{f.name}: {f.dtype.name.lower()}" for f in self.schema()
        )
        return f"DataStream[{type(self._plan).__name__}]({fields})"

    def _wrap(self, plan: lp.LogicalPlan) -> "DataStream":
        return DataStream(plan, self._ctx)

    # -- transforms ------------------------------------------------------
    def select(self, *exprs: Expr | str) -> "DataStream":
        if len(exprs) == 1 and isinstance(exprs[0], (list, tuple)):
            exprs = tuple(exprs[0])
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        return self._wrap(lp.Project(self._plan, exprs))

    def filter(self, predicate: Expr) -> "DataStream":
        return self._wrap(lp.Filter(self._plan, predicate))

    def window(
        self,
        group_exprs: Sequence[Expr | str],
        aggr_exprs: Sequence[AggregateExpr],
        window_length_ms: int,
        slide_ms: int | None = None,
    ) -> "DataStream":
        """Windowed aggregation: tumbling when ``slide_ms`` is None,
        sliding otherwise."""
        group_exprs = [col(g) if isinstance(g, str) else g for g in group_exprs]
        for a in aggr_exprs:
            if not isinstance(a, AggregateExpr):
                raise PlanError(f"{a!r} is not an aggregate expression")
        wt = lp.WindowType.TUMBLING if slide_ms is None else lp.WindowType.SLIDING
        return self._wrap(
            lp.StreamingWindow(
                self._plan,
                list(group_exprs),
                list(aggr_exprs),
                wt,
                int(window_length_ms),
                int(slide_ms) if slide_ms is not None else None,
            )
        )

    # -- execution -------------------------------------------------------
    def collect(self) -> RecordBatch:
        """Execute a bounded stream to completion and return all emitted
        rows."""
        from denormalized_tpu_torch.physical.simple_execs import CollectSink
        from denormalized_tpu_torch.runtime.executor import execute_plan

        s = CollectSink()
        execute_plan(lp.Sink(self._plan, s), self._ctx)
        if not s.batches:
            return RecordBatch.empty(self._plan.schema)
        return s.result()

    def stream(self) -> Iterator[RecordBatch]:
        """Incremental pull-based execution."""
        from denormalized_tpu_torch.runtime.executor import stream_plan

        yield from stream_plan(self._plan, self._ctx)
