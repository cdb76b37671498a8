"""Physical planner: logical plan → executable operator tree.

Counterpart of ``denormalized_tpu/planner/planner.py`` with the scan
(with the idle timeout and partition-watermark mode of live sources),
project, filter, window, join and sink routes.  The window route threads
the engine config's explicit ``device`` and kernel strategy into
:class:`StreamingWindowExec`; the join route its band, retention, band
slack and adaptation knobs into :class:`StreamingJoinExec`.  Sessions,
UDAF windows, the slice path and meshes are not ported yet.
"""

from __future__ import annotations

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.physical.base import ExecOperator
from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
from denormalized_tpu_torch.physical.simple_execs import (
    FilterExec,
    ProjectExec,
    SinkExec,
    SourceExec,
)
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec


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
            if node.window_type is lp.WindowType.SESSION:
                raise PlanError(
                    "session windows not yet ported to denormalized_tpu_torch"
                )
            c = self.config
            return StreamingWindowExec(
                self.create_physical_plan(node.input),
                node.group_exprs,
                node.aggr_exprs,
                node.window_type,
                node.length_ms,
                node.slide_ms,
                device=c.device,
                device_finalize=c.device_finalize,
                min_group_capacity=c.min_group_capacity,
                min_window_slots=c.min_window_slots,
                min_batch_bucket=c.min_batch_bucket,
                device_strategy=c.device_strategy,
                compensated_sums=c.compensated_sums,
                partial_merge_rows=c.partial_merge_rows,
                emit_lag_ms=c.emit_lag_ms,
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
