"""Execution: plan → physical tree → run to completion.

Counterpart of ``denormalized_tpu/runtime/executor.py`` with the logical
optimizer (``EngineConfig.optimizer``), the cold tier, checkpointing and
graceful shutdown: with ``state_budget_bytes`` and ``state_backend_path``
set, every stateful operator gets its spill tier
(``state/tiering.py::attach_spill``, wired before checkpoints so a restore
rebuilds each tier map; the controller is ``ctx._last_spill`` and closes
when the job ends); with ``EngineConfig(checkpoint=True)`` the barrier
orchestrator starts, every operator with ``enable_checkpointing`` is wired to a
:class:`CheckpointCoordinator` over the state backend (and restores from
its committed epoch), and each :class:`Marker` that reaches the root
commits its epoch.  ``execute_plan`` turns SIGINT and SIGTERM into a
:class:`ShutdownFlag` (on the main thread only): the loop stops after the
current item, the orchestrator stops, the old handlers come back and the
call returns normally, so the sources' ``finally`` blocks close their
clients.  The doctor and the exporters are not ported.
"""

from __future__ import annotations

import signal
import threading
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


class ShutdownFlag:
    """Cooperative shutdown, set by the signal handlers."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def set(self) -> None:
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


def _install_signal_handlers(flag: ShutdownFlag):
    """Install SIGINT/SIGTERM → ``flag.set()``; returns a function that
    restores the previous handlers.  Only the main thread may install
    handlers: elsewhere this installs none."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    prev_int = signal.getsignal(signal.SIGINT)
    prev_term = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        flag.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)

    def restore():
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)

    return restore


def build_physical(plan: lp.LogicalPlan, ctx) -> ExecOperator:
    # the JAX package's rules: the same physical plan, so the same
    # checkpoint node ids, as the JAX package builds for the query
    plan = optimize(plan, ctx.config.optimizer)
    return Planner(ctx.config).create_physical_plan(plan)


def _attach_checkpointing(root: ExecOperator, ctx, checkpoint=None):
    """When ``checkpoint`` is on, start the barrier orchestrator and wire
    every source and stateful operator to the coordinator (which restores
    them) → (orchestrator, coordinator), or (None, None).  ``checkpoint``
    overrides ``ctx.config.checkpoint`` for this execution only
    (``explain(analyze=True)`` runs with it False, so an introspection
    run commits no epoch under the real pipeline's node ids and leaves the
    shared EngineConfig alone)."""
    on = checkpoint if checkpoint is not None else ctx.config.checkpoint
    if not on:
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


def _attach_state(root: ExecOperator, ctx, checkpoint=None):
    """The cold tier, then checkpointing → (spill controller, orchestrator,
    coordinator), each None when off.  The tier comes FIRST: a restore
    rebuilds each operator's tier map through the adapter it installs.
    A failure wiring checkpoints closes the controller already made."""
    from denormalized_tpu_torch.state.tiering import attach_spill

    spill = attach_spill(root, ctx)
    ctx._last_spill = spill
    try:
        orch, coord = _attach_checkpointing(root, ctx, checkpoint)
    except BaseException:
        if spill is not None:
            spill.close()
        raise
    ctx._checkpointing = (coord, orch)  # Context.last_checkpointing()
    return spill, orch, coord


def execute_plan(plan: lp.LogicalPlan, ctx, checkpoint=None) -> None:
    root = build_physical(plan, ctx)
    ctx._last_physical = root  # post-run metrics access
    spill, orch, coord = _attach_state(root, ctx, checkpoint)
    flag = ShutdownFlag()
    restore = _install_signal_handlers(flag)
    it = root.run()
    try:
        for item in it:
            if isinstance(item, Marker) and coord is not None:
                # the marker drained at the root: every operator has
                # snapshotted this epoch → make it the recovery point
                coord.commit(item.epoch)
            if flag.is_set() or isinstance(item, EndOfStream):
                break
    finally:
        restore()
        it.close()
        if orch is not None:
            orch.stop()
        if spill is not None:
            spill.close()


def stream_plan(plan: lp.LogicalPlan, ctx) -> Iterator[RecordBatch]:
    root = build_physical(plan, ctx)
    ctx._last_physical = root
    spill, orch, coord = _attach_state(root, ctx)
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
        if spill is not None:
            spill.close()
