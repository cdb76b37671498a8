"""DataStream — the fluent user API.

Counterpart of ``denormalized_tpu/api/data_stream.py`` with the methods the
window, join and Kafka jobs use: select / filter / column renames / window /
join (equi keys, optionally banded) / join_on (expression keys, bands and
residual filters), the plan printers (print_schema, print_plan,
print_physical_plan, explain, explain_analyze), and collect / stream /
print_stream / sink / sink_kafka to run them.  Plan building is lazy;
execution happens in those last five and in the analyze runs.  ``collect``
needs a bounded stream: over a live source it raises.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.expr import AggregateExpr, Column, Expr, col


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

    def __str__(self) -> str:
        return self.__repr__()

    def print_schema(self) -> "DataStream":
        """Print the schema and return self for chaining."""
        print(self.schema())
        return self

    def logical_plan(self) -> lp.LogicalPlan:
        return self._plan

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
        band: "lp.JoinBand | tuple | None" = None,
    ) -> "DataStream":
        """Stream-stream join on equi keys, optionally banded.

        ``band`` adds an interval/range predicate alongside the equi
        keys: ``(left_expr, right_expr, lower_ms, upper_ms)`` (column
        names accepted for the exprs) matches a pair iff ``left -
        right`` lands in ``[lower_ms, upper_ms]`` inclusive, ``None``
        bounds open.  Band expressions evaluate on their OWN side, so
        a band over event time works even though the right side's
        timestamp never appears in the output — the enrichment /
        temporal-correlation join (``ts BETWEEN a AND b``)."""
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
                band=None if band is None else self._flip_band(band),
            )
        if band is not None:
            band = self._as_band(band)
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

    @staticmethod
    def _as_band(band) -> "lp.JoinBand":
        """A ``(left_expr, right_expr, lower_ms, upper_ms)`` tuple (column
        names accepted) as a JoinBand; a JoinBand passes through."""
        if isinstance(band, lp.JoinBand):
            return band
        le, re_, lo, hi = band
        return lp.JoinBand(
            col(le) if isinstance(le, str) else le,
            col(re_) if isinstance(re_, str) else re_,
            lo,
            hi,
        )

    @classmethod
    def _flip_band(cls, band) -> "lp.JoinBand":
        """Mirror a band across a left/right input swap: ``l - r ∈ [a,
        b]`` becomes ``r - l ∈ [-b, -a]``."""
        band = cls._as_band(band)
        return lp.JoinBand(
            band.right_expr,
            band.left_expr,
            None if band.upper_ms is None else -band.upper_ms,
            None if band.lower_ms is None else -band.lower_ms,
        )

    def join_on(
        self, right: "DataStream", join_type: str, on_exprs: Sequence[Expr]
    ) -> "DataStream":
        """Join on arbitrary binary expressions (datastream.rs:126-148).

        ``expr_l == expr_r`` conjuncts where each side references exactly
        one input become equi-keys: non-column sides are computed into
        hidden key columns on their input, the hash join runs on those,
        and the hidden columns are dropped from the output.  Inclusive
        inequality conjuncts comparing a pure-left expression against a
        pure-right expression (± a literal) — the ``l.ts >= r.ts - a``
        / ``l.ts <= r.ts + b`` BETWEEN shape — lower to ONE banded
        predicate evaluated per side before pair materialization
        (lp.JoinBand), which is also the only way to bound against the
        right side's canonical timestamp (it never reaches the pair
        schema).  Any other conjunct (strict inequality, non-equi op,
        or an expression mixing both inputs) becomes a residual filter
        evaluated on matched pairs — the same lowering DataFusion
        applies to the reference's ``join_on``."""
        from denormalized_tpu_torch.logical.expr import BinaryExpr, Literal

        left_names = set(self.schema().names)
        right_names = set(right.schema().names)

        def side_of(e: Expr) -> str | None:
            refs = e.columns_referenced()
            if not refs:
                return None  # literal: computable on either side
            if refs <= left_names and not (refs & right_names):
                return "l"
            if refs <= right_names and not (refs & left_names):
                return "r"
            return None  # ambiguous or mixed — not a separable equi side

        def shifted(e: Expr) -> tuple[Expr, float, str | None]:
            """Decompose ``e`` as ``base + const`` with ``base`` purely
            one-sided: peels one additive numeric literal off a
            BinaryExpr (the ``r.ts + 5000`` shape)."""
            if isinstance(e, BinaryExpr) and e.op in ("+", "-"):
                if isinstance(e.right, Literal) and isinstance(
                    e.right.value, (int, float)
                ):
                    c = float(e.right.value)
                    return e.left, c if e.op == "+" else -c, side_of(e.left)
                if e.op == "+" and isinstance(e.left, Literal) and isinstance(
                    e.left.value, (int, float)
                ):
                    return e.right, float(e.left.value), side_of(e.right)
            return e, 0.0, side_of(e)

        def band_constraint(e: Expr):
            """``(l_expr, r_expr, lower, upper)`` for one inclusive
            inequality conjunct over opposite sides, else None.  Strict
            ops stay residual: the band contract is inclusive and the
            operands may be floats, so ``<`` cannot be rewritten."""
            if not isinstance(e, BinaryExpr) or e.op not in ("<=", ">="):
                return None
            a, ca, sa_ = shifted(e.left)
            b, cb, sb_ = shifted(e.right)
            if {sa_, sb_} != {"l", "r"}:
                return None
            # normalize to  left_expr - right_expr  (op)  const
            if sa_ == "l":
                le_, re2, const = a, b, cb - ca
                op = e.op
            else:
                le_, re2, const = b, a, ca - cb
                op = "<=" if e.op == ">=" else ">="
            if op == "<=":
                return (le_, re2, None, const)
            return (le_, re2, const, None)

        lds, rds = self, right
        lcols: list[str] = []
        rcols: list[str] = []
        hidden: list[str] = []
        residual: Expr | None = None
        band_key = None
        band_exprs = None
        band_lo: float | None = None
        band_hi: float | None = None
        for i, e in enumerate(on_exprs):
            sides = None
            if isinstance(e, BinaryExpr) and e.op == "==":
                if isinstance(e.left, Column) and isinstance(e.right, Column):
                    # plain column == column: key names verbatim (including
                    # the shared-name form col('k') == col('k'), which Join
                    # resolves as a once-appearing shared equi-key)
                    lcols.append(e.left.name)
                    rcols.append(e.right.name)
                    continue
                sl, sr = side_of(e.left), side_of(e.right)
                if {sl, sr} == {"l", "r"}:
                    sides = (e.left, e.right) if sl == "l" else (e.right, e.left)
                elif sl == "l" and sr is None and not e.right.columns_referenced():
                    sides = (e.left, e.right)
                elif sl == "r" and sr is None and not e.left.columns_referenced():
                    sides = (e.right, e.left)
            if sides is None:
                bc = band_constraint(e)
                if bc is not None:
                    le_, re2, lo, hi = bc
                    key = (repr(le_), repr(re2))
                    if band_key is None or key == band_key:
                        band_key = key
                        band_exprs = (le_, re2)
                        if lo is not None:
                            band_lo = (
                                lo if band_lo is None else max(band_lo, lo)
                            )
                        if hi is not None:
                            band_hi = (
                                hi if band_hi is None else min(band_hi, hi)
                            )
                        continue
                    # the exec carries ONE band; a second distinct
                    # expression pair stays a residual pair filter
                residual = e if residual is None else (residual & e)
                continue
            le, re_ = sides
            if isinstance(le, Column):
                lcols.append(le.name)
            else:
                name = f"__join_lk_{i}__"
                lds = lds.with_column(name, le)
                lcols.append(name)
                hidden.append(name)
            if isinstance(re_, Column):
                rcols.append(re_.name)
            else:
                name = f"__join_rk_{i}__"
                rds = rds.with_column(name, re_)
                rcols.append(name)
                hidden.append(name)
        if not lcols:
            raise PlanError(
                "join_on needs at least one separable equi conjunct "
                "(expr_over_left == expr_over_right) — a pure theta join "
                "over unbounded streams has no hash key to bound state"
            )
        band = None
        if band_exprs is not None:
            band = lp.JoinBand(
                band_exprs[0], band_exprs[1], band_lo, band_hi
            )
        out = lds.join(
            rds, join_type, lcols, rcols, filter=residual, band=band
        )
        return out.drop_columns(*hidden) if hidden else out

    # -- introspection ---------------------------------------------------
    def print_plan(self) -> "DataStream":
        print(self._plan.display())
        return self

    def optimized_plan(self) -> lp.LogicalPlan:
        """The logical plan after the optimizer pass (what will execute)."""
        from denormalized_tpu_torch.logical.optimizer import optimize

        return optimize(self._plan)

    def _physical_display(self, plan: lp.LogicalPlan) -> str:
        from denormalized_tpu_torch.planner.planner import Planner

        return Planner(self._ctx.config).create_physical_plan(plan).display()

    def print_physical_plan(self) -> "DataStream":
        print(self._physical_display(self.optimized_plan()))
        return self

    def explain(self, analyze: bool = False) -> "DataStream":
        """Print the logical plan, the optimized plan and the physical plan.
        With ``analyze=True``, run the stream to completion into a discard
        sink and print the physical plan with each operator's metrics
        (rows, batches, device steps and launches).  Like ``collect``,
        analyze needs a bounded source; it runs with checkpointing off, so
        it commits no epoch under the real pipeline's node ids."""
        opt = self.optimized_plan()
        print("== logical plan ==")
        print(self._plan.display())
        print("== optimized plan ==")
        print(opt.display())
        if not analyze:
            print("== physical plan ==")
            print(self._physical_display(opt))
            return self
        from denormalized_tpu_torch.physical.simple_execs import CallbackSink

        self._execute(CallbackSink(lambda _b: None), checkpoint=False)
        print("== physical plan (analyzed) ==")
        print(self._ctx._last_physical.display(with_metrics=True))
        return self

    def explain_analyze(self, print_output: bool = True) -> str:
        """Run into a discard sink (checkpointing off, a bounded source)
        and return the physical plan annotated with each operator's
        metrics: the text the JAX package gives with its pipeline doctor
        off.  The doctor's ranked bottleneck report
        (``obs/doctor/attribution.py``) is not ported yet: it comes with
        ROADMAP §A item 10."""
        from denormalized_tpu_torch.physical.simple_execs import CallbackSink

        self._execute(CallbackSink(lambda _b: None), checkpoint=False)
        text = self._ctx._last_physical.display(with_metrics=True)
        if print_output:
            print(text)
        return text

    # -- execution -------------------------------------------------------
    def _execute(self, sink, checkpoint=None) -> None:
        from denormalized_tpu_torch.runtime.executor import execute_plan

        execute_plan(lp.Sink(self._plan, sink), self._ctx, checkpoint)

    def print_stream(self) -> None:
        """Execute, printing rows as JSON (datastream.rs:311-339)."""
        from denormalized_tpu_torch.physical.simple_execs import PrintSink

        self._execute(PrintSink())

    def sink(
        self, fn: Callable[[RecordBatch], None], *, as_pyarrow: bool = False
    ) -> None:
        """Execute, calling ``fn`` per emitted batch (the PyO3 sink_python
        path).  With ``as_pyarrow=True`` the callback receives
        ``pyarrow.RecordBatch`` objects, as the reference hands its Python
        callbacks; that needs the ``pyarrow`` package."""
        from denormalized_tpu_torch.physical.simple_execs import CallbackSink

        if as_pyarrow:
            try:
                import pyarrow  # noqa: F401
            except ImportError as e:
                raise PlanError(
                    "sink(as_pyarrow=True) needs the pyarrow package, which "
                    "is not installed; use sink(fn) for RecordBatches"
                ) from e
            user_fn = fn
            fn = lambda b: user_fn(b.to_pyarrow())  # noqa: E731
        self._execute(CallbackSink(fn))

    def sink_kafka(self, bootstrap_servers: str, topic: str) -> None:
        """Execute, producing JSON rows to a Kafka topic
        (datastream.rs:346-374)."""
        from denormalized_tpu_torch.sources.kafka import KafkaSinkWriter

        self._execute(KafkaSinkWriter(bootstrap_servers, topic))

    def collect(self) -> RecordBatch:
        """Execute a bounded stream to completion and return all emitted
        rows.  Over a live (unbounded) source it raises: such a stream
        never ends, so read it with stream() or a sink."""
        from denormalized_tpu_torch.physical.simple_execs import CollectSink

        live = sorted(
            str(n.source.name) for n in _scans(self._plan) if n.source.unbounded
        )
        if live:
            raise PlanError(
                f"collect() needs a bounded stream, but source(s) {live} "
                "are unbounded (live topics never end); use stream(), "
                "sink(), print_stream() or sink_kafka()"
            )
        s = CollectSink()
        self._execute(s)
        if not s.batches:
            return RecordBatch.empty(self._plan.schema)
        return s.result()

    def stream(self) -> Iterator[RecordBatch]:
        """Incremental pull-based execution."""
        from denormalized_tpu_torch.runtime.executor import stream_plan

        yield from stream_plan(self._plan, self._ctx)


def _scans(plan: lp.LogicalPlan):
    """Every Scan under ``plan``."""
    if isinstance(plan, lp.Scan):
        yield plan
    for c in plan.children:
        yield from _scans(c)
