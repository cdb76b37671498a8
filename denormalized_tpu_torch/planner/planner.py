"""Physical planner: logical plan → executable operator tree.

Counterpart of ``denormalized_tpu/planner/planner.py`` with the scan
(with the idle timeout and partition-watermark mode of live sources),
project, filter, window, session, join and sink routes.  A window picks its
operator: a session window the vectorized :class:`SessionWindowExec` (or,
with ``DENORMALIZED_SESSION_REFERENCE=1``, the pre-vectorization
``ReferenceSessionWindowExec``, the JAX package's differential oracle);
a window holding any accumulator aggregate :class:`UdafWindowExec`; every
other window :class:`StreamingWindowExec`, with the engine config's
explicit ``device``, kernel strategy, ``accum_dtype``,
``emission_compaction`` and ``host_pipeline``.  Approximate aggregates
lower to their exact accumulators first (the JAX package plans them as
sketches only on its slice path, not ported yet).  The join route threads
its band, retention, band slack and adaptation knobs into
:class:`StreamingJoinExec`.  The slice path and meshes are not ported yet.
"""

from __future__ import annotations

import os

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.expr import SKETCH_AGG_KINDS, AggregateExpr
from denormalized_tpu_torch.physical.base import ExecOperator
from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
from denormalized_tpu_torch.physical.simple_execs import (
    FilterExec,
    ProjectExec,
    SinkExec,
    SourceExec,
)
from denormalized_tpu_torch.physical.session_exec import SessionWindowExec
from denormalized_tpu_torch.physical.session_reference import (
    ReferenceSessionWindowExec,
)
from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec


def route_approx(aggs: list[AggregateExpr]) -> list[AggregateExpr]:
    """Lower each approximate aggregate to the exact accumulator UDAF it
    carries — what the JAX package does off its slice path, which includes
    its default configuration."""
    lowered = []
    for a in aggs:
        if a.kind in SKETCH_AGG_KINDS:
            if a.udaf is None:
                raise PlanError(
                    f"approximate aggregate {a.name!r} has no accumulator "
                    "fallback (sketch aggregates plan natively only on the "
                    "multi-query slice path, ROADMAP §A item 8)"
                )
            a = AggregateExpr("udaf", a.arg, a._alias, a.udaf)
        lowered.append(a)
    return lowered


class Planner:
    def __init__(self, config) -> None:
        # config: api.context.EngineConfig (device already resolved)
        self.config = config

    def create_physical_plan(self, node: lp.LogicalPlan) -> ExecOperator:
        if isinstance(node, lp.Scan):
            return SourceExec(
                node.source,
                idle_timeout_ms=self.config.source_idle_timeout_ms,
                partition_watermarks=self.config.partition_watermarks,
            )
        if isinstance(node, lp.Project):
            return ProjectExec(
                self.create_physical_plan(node.input), node.exprs, node.schema
            )
        if isinstance(node, lp.Filter):
            return FilterExec(
                self.create_physical_plan(node.input), node.predicate
            )
        if isinstance(node, lp.StreamingWindow):
            c = self.config
            child = self.create_physical_plan(node.input)
            aggr_exprs = route_approx(node.aggr_exprs)
            if node.window_type is lp.WindowType.SESSION:
                # sessions take builtin AND accumulator aggregates in one
                # operator; the switch selects the JAX package's
                # differential oracle
                cls = (
                    ReferenceSessionWindowExec
                    if os.environ.get("DENORMALIZED_SESSION_REFERENCE") == "1"
                    else SessionWindowExec
                )
                return cls(
                    child,
                    node.group_exprs,
                    aggr_exprs,
                    gap_ms=node.length_ms,
                    emit_on_close=c.emit_on_close,
                )
            if any(a.kind == "udaf" for a in aggr_exprs):
                return UdafWindowExec(
                    child,
                    node.group_exprs,
                    aggr_exprs,
                    node.window_type,
                    node.length_ms,
                    node.slide_ms,
                    emit_on_close=c.emit_on_close,
                )
            return StreamingWindowExec(
                child,
                node.group_exprs,
                aggr_exprs,
                node.window_type,
                node.length_ms,
                node.slide_ms,
                device=c.device,
                accum_dtype=c.accum_dtype,
                emission_compaction=c.emission_compaction,
                device_finalize=c.device_finalize,
                min_group_capacity=c.min_group_capacity,
                min_window_slots=c.min_window_slots,
                min_batch_bucket=c.min_batch_bucket,
                device_strategy=c.device_strategy,
                compensated_sums=c.compensated_sums,
                partial_merge_rows=c.partial_merge_rows,
                emit_lag_ms=c.emit_lag_ms,
                host_pipeline=c.host_pipeline,
                emit_on_close=c.emit_on_close,
            )
        if isinstance(node, lp.Join):
            c = self.config
            return StreamingJoinExec(
                self.create_physical_plan(node.left),
                self.create_physical_plan(node.right),
                node.kind,
                node.left_keys,
                node.right_keys,
                node.filter,
                node.schema,
                retention_ms=c.join_retention_ms,
                band=node.band,
                band_slack_ms=c.join_band_slack_ms,
                adaptive=bool(c.join_adaptive),
                adapt_interval_s=c.join_adapt_interval_s,
            )
        if isinstance(node, lp.Sink):
            return SinkExec(self.create_physical_plan(node.input), node.sink)
        raise PlanError(f"no physical rule for {type(node).__name__}")
