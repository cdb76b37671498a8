"""Execution: plan → physical tree → run to completion.

Counterpart of ``denormalized_tpu/runtime/executor.py`` without
checkpointing, the doctor, exporters or signal handling.
"""

from __future__ import annotations

from typing import Iterator

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.physical.base import EndOfStream, ExecOperator
from denormalized_tpu_torch.planner.planner import Planner


def build_physical(plan: lp.LogicalPlan, ctx) -> ExecOperator:
    return Planner(ctx.config).create_physical_plan(plan)


def execute_plan(plan: lp.LogicalPlan, ctx) -> None:
    root = build_physical(plan, ctx)
    ctx._last_physical = root  # post-run metrics access
    for item in root.run():
        if isinstance(item, EndOfStream):
            break


def stream_plan(plan: lp.LogicalPlan, ctx) -> Iterator[RecordBatch]:
    root = build_physical(plan, ctx)
    ctx._last_physical = root
    it = root.run()
    try:
        for item in it:
            if isinstance(item, RecordBatch):
                yield item
            elif isinstance(item, EndOfStream):
                break
    finally:
        it.close()
