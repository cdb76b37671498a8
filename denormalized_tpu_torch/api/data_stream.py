"""DataStream — the fluent user API.

Counterpart of ``denormalized_tpu/api/data_stream.py`` with the methods the
window and join jobs use: select / filter / column renames / window /
join, and collect / stream to run them.  Plan building is lazy; execution
happens in collect and stream.  ``join_on`` and band joins are not ported:
those calls raise PlanError.
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

    def select_columns(self, *names: str) -> "DataStream":
        return self.select(*[col(n) for n in names])

    def filter(self, predicate: Expr) -> "DataStream":
        return self._wrap(lp.Filter(self._plan, predicate))

    def with_column(self, name: str, expr: Expr) -> "DataStream":
        """Add or replace a column (datastream.rs:107-114)."""
        exprs: list[Expr] = []
        replaced = False
        for f in self._plan.schema.without_internal():
            if f.name == name:
                exprs.append(expr.alias(name))
                replaced = True
            else:
                exprs.append(col(f.name))
        if not replaced:
            exprs.append(expr.alias(name))
        return self.select(*exprs)

    def with_column_renamed(self, old: str, new: str) -> "DataStream":
        exprs = [
            col(f.name).alias(new) if f.name == old else col(f.name)
            for f in self._plan.schema.without_internal()
        ]
        return self.select(*exprs)

    def drop_columns(self, *names: str) -> "DataStream":
        # the reference's spelling is a list — accept both
        if len(names) == 1 and isinstance(names[0], (list, tuple)):
            names = tuple(names[0])
        keep = [
            col(f.name)
            for f in self._plan.schema.without_internal()
            if f.name not in set(names)
        ]
        return self.select(*keep)

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

    # -- joins (datastream.rs:126-177) -----------------------------------
    # reference JoinType spellings → JoinKind; right-side existence joins
    # normalize to the left-side kind with swapped inputs
    _JOIN_TYPE_ALIASES = {
        "semi": "left_semi", "leftsemi": "left_semi",
        "left_semi": "left_semi",
        "anti": "left_anti", "leftanti": "left_anti",
        "left_anti": "left_anti",
        "rightsemi": "right_semi", "right_semi": "right_semi",
        "rightanti": "right_anti", "right_anti": "right_anti",
    }

    def join(
        self,
        right: "DataStream",
        join_type: str = "inner",
        left_cols: Sequence[str] = (),
        right_cols: Sequence[str] = (),
        filter: Expr | None = None,
        band=None,
    ) -> "DataStream":
        """Stream-stream join on equi keys (inner, left, right, full, semi,
        anti, right_semi, right_anti), with an optional residual
        ``filter`` over matched pairs.  ``band`` is the JAX package's
        interval predicate, not ported yet: passing one raises
        (``lp.Join``)."""
        jt = self._JOIN_TYPE_ALIASES.get(
            join_type.lower().replace(" ", ""), join_type.lower()
        )
        if jt in ("right_semi", "right_anti"):
            # RightSemi(a,b) == LeftSemi(b,a): swap inputs and key lists
            return right.join(
                self,
                jt.replace("right", "left"),
                list(right_cols),
                list(left_cols),
                filter,
                band,
            )
        return self._wrap(
            lp.Join(
                self._plan,
                right._plan,
                lp.JoinKind(jt),
                list(left_cols),
                list(right_cols),
                filter,
                band,
            )
        )

    def join_on(self, right: "DataStream", join_type: str, on_exprs):
        """Join on arbitrary binary expressions — not ported yet (it lowers
        expression keys through the scalar functions, which the port does
        not have)."""
        raise PlanError("join_on is not yet ported to denormalized_tpu_torch")

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
