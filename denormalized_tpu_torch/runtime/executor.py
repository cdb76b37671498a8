"""Execution: plan → physical tree → run to completion.

Counterpart of ``denormalized_tpu/runtime/executor.py`` with the logical
optimizer and checkpointing: with ``EngineConfig(checkpoint=True)`` the
barrier orchestrator starts, every operator with ``enable_checkpointing``
is wired to a :class:`CheckpointCoordinator` over the state backend (and
restores from its committed epoch), and each :class:`Marker` that reaches
the root commits its epoch.  The doctor, exporters and signal handling are
not ported.
"""

from __future__ import annotations

from typing import Iterator

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.optimizer import optimize
from denormalized_tpu_torch.physical.base import (
    EndOfStream,
    ExecOperator,
    Marker,
)
from denormalized_tpu_torch.planner.planner import Planner


def build_physical(plan: lp.LogicalPlan, ctx) -> ExecOperator:
    # the JAX package's rules: the same physical plan, so the same
    # checkpoint node ids, as the JAX package builds for the query
    return Planner(ctx.config).create_physical_plan(optimize(plan))


def _attach_checkpointing(root: ExecOperator, ctx):
    """When ``checkpoint`` is on, start the barrier orchestrator and wire
    every source and stateful operator to the coordinator (which restores
    them) → (orchestrator, coordinator), or (None, None)."""
    if not ctx.config.checkpoint:
        return None, None
    from denormalized_tpu_torch.state.checkpoint import wire_checkpointing
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    orch = Orchestrator(interval_s=ctx.config.checkpoint_interval_s)
    try:
        coord = wire_checkpointing(root, ctx, orch)
        orch.start()
    except BaseException:
        orch.stop()
        raise
    return orch, coord


def execute_plan(plan: lp.LogicalPlan, ctx) -> None:
    root = build_physical(plan, ctx)
    ctx._last_physical = root  # post-run metrics access
    orch, coord = _attach_checkpointing(root, ctx)
    ctx._checkpointing = (coord, orch)  # Context.last_checkpointing()
    it = root.run()
    try:
        for item in it:
            if isinstance(item, Marker) and coord is not None:
                # the marker drained at the root: every operator has
                # snapshotted this epoch → make it the recovery point
                coord.commit(item.epoch)
            elif isinstance(item, EndOfStream):
                break
    finally:
        it.close()
        if orch is not None:
            orch.stop()


def stream_plan(plan: lp.LogicalPlan, ctx) -> Iterator[RecordBatch]:
    root = build_physical(plan, ctx)
    ctx._last_physical = root
    orch, coord = _attach_checkpointing(root, ctx)
    ctx._checkpointing = (coord, orch)
    it = root.run()
    try:
        for item in it:
            if isinstance(item, RecordBatch):
                yield item
            elif isinstance(item, Marker) and coord is not None:
                coord.commit(item.epoch)
            elif isinstance(item, EndOfStream):
                break
    finally:
        it.close()
        if orch is not None:
            orch.stop()
