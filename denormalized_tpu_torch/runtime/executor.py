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
clients.

Each execution resolves its metrics registry once (``_resolve_registry``:
the thread's current registry, or the shared disabled one when
``metrics_enabled`` is False) and builds and drives its operators under
``obs.bound_registry``, so two queries in one process keep separate
series.  The exporters the config opts into start with the job
(``obs.start_exporters``, ``ctx._last_exporters``) and the job registers
with the pipeline doctor (``doctor.register_query``, ``ctx._last_doctor``);
both stop after the last emission.
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


def _resolve_registry(ctx):
    """The metrics registry THIS execution binds against: the thread's
    current registry when the config enables metrics, the shared
    always-disabled registry otherwise — per query, so two concurrent
    executions with different ``metrics_enabled`` settings bind live
    handles or nulls according to their own config."""
    from denormalized_tpu_torch import obs

    if getattr(ctx.config, "metrics_enabled", True):
        return obs.current_registry()
    return obs.disabled_registry()


def build_physical(plan: lp.LogicalPlan, ctx) -> ExecOperator:
    from denormalized_tpu_torch import obs

    # the JAX package's rules: the same physical plan, so the same
    # checkpoint node ids, as the JAX package builds for the query.
    # Operators bind their instruments once, at construction, under the
    # query's registry
    plan = optimize(plan, ctx.config.optimizer)
    with obs.bound_registry(_resolve_registry(ctx)):
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


def _start_services(root, ctx):
    """The exporters the config opts into (None when none), then the
    doctor's registration (None when it is off) — both scoped to the
    query's registry, bound by the caller."""
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.obs import doctor

    exporters = obs.start_exporters(ctx.config, registry=obs.current_registry())
    ctx._last_exporters = exporters
    try:
        handle = doctor.register_query(
            root, config=ctx.config, registry=obs.current_registry()
        )
    except BaseException:
        if exporters is not None:
            exporters.stop()
        raise
    ctx._last_doctor = handle
    return exporters, handle


def _stop_services(exporters, handle) -> None:
    """Freeze the doctor's final snapshot (and drop its reference to the
    operator tree) BEFORE the exporters stop, so the last JSONL snapshot,
    the trace dump and the doctor agree on the end state."""
    if handle is not None:
        handle.finish()
    if exporters is not None:
        exporters.stop()


def execute_plan(plan: lp.LogicalPlan, ctx, checkpoint=None) -> None:
    from denormalized_tpu_torch import obs

    reg = _resolve_registry(ctx)
    with obs.bound_registry(reg):
        root = build_physical(plan, ctx)
        ctx._last_physical = root  # post-run metrics access
        spill, orch, coord = _attach_state(root, ctx, checkpoint)
        exporters = handle = None
        flag = ShutdownFlag()
        restore = lambda: None  # noqa: E731
        it = None
        try:
            exporters, handle = _start_services(root, ctx)
            restore = _install_signal_handlers(flag)
            it = root.run()
            for item in it:
                if isinstance(item, Marker) and coord is not None:
                    # the marker drained at the root: every operator has
                    # snapshotted this epoch → make it the recovery point
                    coord.commit(item.epoch)
                if flag.is_set() or isinstance(item, EndOfStream):
                    break
        finally:
            restore()
            if it is not None:
                it.close()
            if orch is not None:
                orch.stop()
            if spill is not None:
                spill.close()
            _stop_services(exporters, handle)


def stream_plan(plan: lp.LogicalPlan, ctx) -> Iterator[RecordBatch]:
    from denormalized_tpu_torch import obs

    reg = _resolve_registry(ctx)
    spill = orch = coord = exporters = handle = it = None
    try:
        with obs.bound_registry(reg):
            root = build_physical(plan, ctx)
            ctx._last_physical = root
            spill, orch, coord = _attach_state(root, ctx)
            exporters, handle = _start_services(root, ctx)
        # re-enter the binding around each RESUMPTION, never across a
        # yield: a paused stream must not leave its registry on the
        # consumer thread's binding stack (a query built between pulls
        # would bind into it).  Worker threads bind through the registry
        # their component captured at construction
        it = root.run()
        while True:
            with obs.bound_registry(reg):
                try:
                    item = next(it)
                except StopIteration:
                    break
            if isinstance(item, RecordBatch):
                yield item
            elif isinstance(item, Marker) and coord is not None:
                coord.commit(item.epoch)
            elif isinstance(item, EndOfStream):
                break
    finally:
        with obs.bound_registry(reg):
            # close the operator chain first (its own finally blocks: pump
            # shutdown, worker joins), then the per-query services
            if it is not None:
                it.close()
            if orch is not None:
                orch.stop()
            if spill is not None:
                spill.close()
            _stop_services(exporters, handle)
