"""Physical planner: logical plan → executable operator tree.

Counterpart of ``denormalized_tpu/planner/planner.py`` with the scan
(with the idle timeout and partition-watermark mode of live sources),
project, filter, window, session, join and sink routes.  A window picks its
operator: a session window the vectorized :class:`SessionWindowExec` (or,
with ``DENORMALIZED_SESSION_REFERENCE=1``, the pre-vectorization
``ReferenceSessionWindowExec``, the JAX package's differential oracle);
a window holding any accumulator aggregate :class:`UdafWindowExec`; under
``EngineConfig(slice_windows=True)`` every other window the host
:class:`SliceWindowExec` (one subscriber, with ``slice_unit_ms`` and
``slice_sort_lane``); otherwise :class:`StreamingWindowExec`, with the
engine config's explicit ``device``, kernel strategy, ``accum_dtype``,
``emission_compaction`` and ``host_pipeline``.  Approximate aggregates
stay sketch kinds on the slice path (``approx_native``, the default) and
lower to their exact accumulators everywhere else, as in the JAX package
(:meth:`Planner._route_approx`).  The join route threads its band,
retention, band slack and adaptation knobs into
:class:`StreamingJoinExec`.  A logical node with a ``create_exec`` hook
(the cluster's ``ExchangeScan`` leaf) builds its own operator.  Meshes
are not ported yet (ROADMAP §A item 9), so the JAX package's mesh
clauses are absent.
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
from denormalized_tpu_torch.physical.slice_exec import (
    SliceSubscriber,
    SliceWindowExec,
)
from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec


class Planner:
    def __init__(self, config) -> None:
        # config: api.context.EngineConfig (device already resolved)
        self.config = config

    def _route_approx(self, node) -> list:
        """Route approximate aggregates: on the slice path they stay
        first-class sketch kinds (constant-state mergeable planes,
        ops/sketches.py); everywhere else — sessions, the device ring,
        default config, plans mixing true UDAFs, or
        ``approx_native=False`` — each lowers to the exact accumulator
        UDAF it carries."""
        aggs = node.aggr_exprs
        if not any(a.kind in SKETCH_AGG_KINDS for a in aggs):
            return aggs
        native = (
            node.window_type is not lp.WindowType.SESSION
            and self.config.slice_windows
            and self.config.approx_native
            and not any(a.kind == "udaf" for a in aggs)
        )
        if native:
            return aggs
        lowered = []
        for a in aggs:
            if a.kind in SKETCH_AGG_KINDS:
                if a.udaf is None:
                    raise PlanError(
                        f"approximate aggregate {a.name!r} has no "
                        "accumulator fallback and the plan cannot take "
                        "the slice path (sketch aggregates need "
                        "EngineConfig(slice_windows=True) here)"
                    )
                lowered.append(
                    AggregateExpr("udaf", a.arg, a._alias, a.udaf)
                )
            else:
                lowered.append(a)
        return lowered

    def create_physical_plan(self, node: lp.LogicalPlan) -> ExecOperator:
        # extension point: a logical node that knows how to build its own
        # exec (the cluster runtime's ExchangeScan leaf) builds it here —
        # the planner stays ignorant of subsystem-specific operators
        hook = getattr(node, "create_exec", None)
        if hook is not None:
            return hook(self)
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
            aggr_exprs = self._route_approx(node)
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
            if c.slice_windows:
                # slice-fold path (docs/multi_query.md): every foldable
                # aggregate folds from slice partials, so a sliding window
                # pays O(1) per row + O(L/slide) per emitted window instead
                # of the k-way fan-out.  Host kernel: nothing runs on the
                # card
                return SliceWindowExec(
                    child,
                    node.group_exprs,
                    [
                        SliceSubscriber(
                            aggr_exprs,
                            node.length_ms,
                            node.slide_ms or node.length_ms,
                        )
                    ],
                    emit_on_close=c.emit_on_close,
                    unit_ms=c.slice_unit_ms,
                    sort_lane=c.slice_sort_lane,
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
