"""Physical operator protocol — counterpart of
``denormalized_tpu/physical/base.py``: the stream items, the operator base
with its observability hooks (``bind_obs``, the doctor's busy-time bracket
``_note_batch`` and input-wait iterator ``_doctor_input``, the state
observatory's gauges), and ``display``, which prints the operator tree with
each operator's metrics on request.

The physical layer is a pull-based pipeline of Python generators flowing
:class:`StreamItem`s:

- ``RecordBatch`` — data;
- :class:`Marker` — an in-band checkpoint barrier: each stateful operator
  snapshots when it passes, and the executor commits the epoch when it
  reaches the root;
- :class:`WatermarkHint` — an event-time advance that does not ride a
  batch: a join's clamped joint watermark, or an idle source's one-shot;
- :class:`EndOfStream` — bounded input exhausted (replay/test sources); the
  windowed operator flushes open windows on receipt.

Heavy compute happens inside operators (device steps in the window exec);
the generator plumbing between them moves only batch references.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Union

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.obs.registry import NULL as _OBS_NULL


@dataclass(frozen=True)
class WatermarkHint:
    """Event-time advance that does not ride a batch.  Two kinds:

    - ``"idle"`` — advisory one-shot: no further rows at or before
      ``ts_ms`` are expected, so stateful operators may close windows up
      to it;
    - ``"partition"`` — AUTHORITATIVE watermark: operators that see one
      stop advancing their watermark from raw batch min-ts.  The join
      announces this mode before its first output and then emits its
      clamped joint watermark, since a joined row can be as old as the
      eviction horizon.  A hint with ``ts_ms <= WM_ANNOUNCE`` is a pure
      mode announcement carrying no timestamp.

    Stateless operators pass both kinds through; the sink and the root
    loops skip them."""

    ts_ms: int
    kind: str = "idle"

    @property
    def is_announcement(self) -> bool:
        """Pure mode announcement: switches operators to hint-driven
        watermarks without advancing anything.  Every stateful operator
        uses THIS check, so the rule cannot drift between call sites."""
        return self.ts_ms <= WM_ANNOUNCE


#: mode-announcement sentinel: a kind="partition" hint at or below this
#: value switches operators to hint-driven watermarks without advancing
#: anything
WM_ANNOUNCE = -(2**62)


@dataclass(frozen=True)
class Marker:
    """Checkpoint barrier of epoch ``epoch`` (reference
    OrchestrationMessage::CheckpointBarrier, orchestrator.rs:12-16)."""

    epoch: int


@dataclass(frozen=True)
class EndOfStream:
    pass


EOS = EndOfStream()

StreamItem = Union[RecordBatch, Marker, WatermarkHint, EndOfStream]


class ExecOperator:
    """One node of the physical plan."""

    #: output schema
    schema: Schema

    #: registry handles (no-op defaults so an operator that never calls
    #: bind_obs — test doubles subclassing ExecOperator directly — still
    #: runs; real operators bind in their constructors)
    _obs_rows_in = _OBS_NULL
    _obs_batch_ms = _OBS_NULL
    _obs_input_wait = _OBS_NULL

    #: doctor per-node stats (obs/doctor): plain single-writer attribute
    #: adds — one float/int add per batch or item, independent of the
    #: registry so attribution works even with metrics disabled.  Class
    #: defaults keep un-doctored operator instances (test doubles, direct
    #: build_physical callers) inert.
    _dr_busy_ms = 0.0
    _dr_batches = 0
    _dr_rows_in = 0
    _dr_input_wait_s = 0.0
    _dr_node_id: str | None = None
    _dr_lineage = None  # obs.doctor.lineage.LineageTracker when sampling

    #: state observatory (obs/statewatch.py): stateful operators set
    #: ``_sw`` (and, for the join, ``_sw_right``) to a StateWatch at
    #: construction and implement ``state_info()``.  The class defaults
    #: keep stateless operators entirely inert — one ``is None`` check
    #: in _note_batch is their whole cost.
    _sw = None
    _sw_last_refresh = 0.0
    _state_info_cache: tuple | None = None
    #: gid -> display key of the hot keys, resolved on the operator's own
    #: thread at each hot-gauge refresh.  The doctor's /state reads this
    #: from its HTTP thread and never the interner, whose native table
    #: only the operator thread may touch (it grows without a lock).
    _hot_names: dict = {}

    def bind_obs(self, op: str) -> None:
        """Bind this operator's registry instruments (obs subsystem):
        rows-in counter, per-batch processing-time histogram, and the
        doctor's upstream-wait histogram, labeled ``op=<label>``.
        Called once from each operator's constructor; with metrics
        disabled the handles are shared no-op nulls, so the hot path
        stays allocation-free."""
        from denormalized_tpu_torch import obs

        self._obs_rows_in = obs.counter("dnz_op_rows_in_total", op=op)
        self._obs_batch_ms = obs.histogram("dnz_op_batch_ms", op=op)
        self._obs_input_wait = obs.histogram(
            "dnz_op_input_wait_ms", op=op
        )

    # -- doctor handoff instrumentation (obs/doctor) ---------------------
    def _note_batch(self, t0: float, rows: int) -> None:
        """Close a batch-processing bracket opened at ``perf_counter()``
        ``t0``: feeds both the registry histogram and the doctor's
        per-node busy accounting.  Emissions must be materialized before
        calling (time suspended in downstream operators is never this
        operator's busy time).  On a CUDA ring the bracket holds the
        kernels' dispatch and the emission's copy to the host, which waits
        for the card; nothing here synchronizes the device."""
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._obs_batch_ms.observe(dt_ms)
        self._dr_busy_ms += dt_ms
        self._dr_batches += 1
        self._dr_rows_in += rows
        if self._sw is not None:
            self._refresh_hot_gauges()

    def _note_input_wait(self, dt_s: float) -> None:
        """Record one upstream-handoff wait (time this operator spent
        suspended before the next stream item arrived).  Multi-input
        operators (the join's merged queue) call this directly; single-
        input operators get it via :meth:`_doctor_input`."""
        self._dr_input_wait_s += dt_s
        if self._obs_input_wait:
            self._obs_input_wait.observe(dt_s * 1e3)

    def _doctor_input(self, input_op: "ExecOperator | None" = None
                      ) -> Iterator[StreamItem]:
        """Iterate the upstream operator with the doctor's handoff
        instrumentation: every pull is timed (queue-wait attribution)
        and, when record lineage is sampling, rowful batches covering a
        sampled record register a hop at this node.  Every operator that
        overrides the batch-processing path must consume its input
        through this (or :meth:`_note_input_wait`)."""
        it = (input_op if input_op is not None else self.input_op).run()
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self._note_input_wait(time.perf_counter() - t0)
            if (
                self._dr_lineage is not None
                and isinstance(item, RecordBatch)
                and item.num_rows
            ):
                self._dr_lineage.hop(self._dr_node_id, item)
            yield item

    # -- state observatory (obs/statewatch.py) --------------------------
    def state_info(self) -> dict | None:
        """Exact state accounting of a STATEFUL operator (None for
        stateless ones): live bytes / live keys / slot capacity vs
        occupancy / oldest retained event time.  Pull-only — computed
        when a snapshot or exporter asks, never on the hot path.
        Implementations read single-writer operator state defensively;
        a read racing teardown may return stale numbers, never raise
        into the caller (gauge_fns degrade to 0, the doctor wraps)."""
        return None

    def _state_watch_views(self):
        """(side_label_or_None, watch, resolve_fn) per sketch this
        operator feeds — the hot-key gauge refresh and the doctor's
        /state endpoint both iterate this.  Default: the single ``_sw``
        with no side label and no key resolution."""
        if self._sw is None:
            return []
        return [(None, self._sw, None)]

    def _cached_state_info(self, max_age_s: float = 0.2) -> dict | None:
        """state_info() memoized briefly so the per-node gauge family
        (bytes/keys/slots/lag) costs ONE accounting pass per export
        cycle, not one per instrument."""
        c = self._state_info_cache
        now = time.monotonic()
        if c is not None and now - c[0] < max_age_s:
            return c[1]
        info = self.state_info()
        self._state_info_cache = (now, info)
        return info

    def bind_state_obs(self, node_id: str) -> None:
        """Bind the state observatory's registry view for this operator
        under its plan node id.  Called by ``doctor.register_query``
        once node ids exist (the same DFS ids the checkpointer uses) —
        under the query's bound registry.  Every gauge_fn holds a
        weakref: the registry must never pin a finished query's
        operator graph (the ``dnz_decode_fallback_rows`` rule).

        Reading the state-bytes gauge also appends a growth-ring sample
        to the operator's watch, so the JSONL/Prometheus export cadence
        IS the forecast history."""
        if self.state_info() is None and self._sw is None:
            return  # stateless operator: nothing to account
        import weakref

        from denormalized_tpu_torch import obs

        ref = weakref.ref(self)

        def field(name, sample=False):
            def read():
                op = ref()
                if op is None:
                    return 0
                info = op._cached_state_info()
                if not info:
                    return 0
                v = info.get(name) or 0
                if sample and op._sw is not None:
                    op._sw.record_sample(v)
                return v

            return read

        obs.gauge_fn(
            "dnz_state_bytes", field("state_bytes", sample=True),
            node=node_id,
        )
        obs.gauge_fn(
            "dnz_state_live_keys", field("live_keys"), node=node_id
        )
        obs.gauge_fn(
            "dnz_state_slots", field("slot_capacity"),
            node=node_id, kind="capacity",
        )
        obs.gauge_fn(
            "dnz_state_slots", field("slot_live"),
            node=node_id, kind="live",
        )
        obs.gauge_fn(
            "dnz_state_oldest_event_lag_ms", field("oldest_event_lag_ms"),
            node=node_id,
        )
        # cold tier (state/tiering.py): zero when no budget/backend is
        # configured or nothing is spilled — the same state_info fields
        # the /state endpoint and the spill-thrashing verdict read
        obs.gauge_fn(
            "dnz_state_spilled_bytes", field("spilled_bytes"), node=node_id
        )
        obs.gauge_fn(
            "dnz_state_spilled_keys", field("spilled_keys"), node=node_id
        )

        def skew():
            from denormalized_tpu_torch.obs.statewatch import side_live_keys

            op = ref()
            if op is None or op._sw is None:
                return 0
            info = op._cached_state_info() or {}
            views = op._state_watch_views()
            best = 0.0
            for side, watch, _resolve in views:
                s = watch.skew_factor(side_live_keys(info, side))
                if s is not None and s > best:
                    best = s
            return best

        obs.gauge_fn("dnz_state_skew_factor", skew, node=node_id)

    def _refresh_hot_gauges(self, force: bool = False) -> None:
        """Refresh the ``dnz_state_hot_key_share`` gauge family from
        this operator's sketch(es).  Runs on the operator's own thread
        (single-writer), rate-limited to ~1 Hz from _note_batch; keys
        that drop out of the top-K are zeroed (the registry has no
        series eviction by design)."""
        node = self._dr_node_id
        sw = self._sw
        if not sw or node is None:
            return
        now = time.monotonic()
        if not force and now - self._sw_last_refresh < 1.0:
            return
        self._sw_last_refresh = now
        from denormalized_tpu_torch import obs

        names: dict = {}
        for side, watch, resolve in self._state_watch_views():
            if not watch:
                continue
            labels = {"node": node}
            if side is not None:
                labels["side"] = side
            hot = watch.hot_keys(8, resolve=_noting_names(resolve, names))
            bound = watch._hot_bound
            live_keys = set()
            for h in hot:
                key = h["key"]
                live_keys.add(key)
                g = bound.get(key)
                if g is None:
                    g = obs.gauge(
                        "dnz_state_hot_key_share", key=key, **labels
                    )
                    bound[key] = g
                g.set(h["share"])
            for key, g in bound.items():
                if key not in live_keys:
                    g.set(0.0)
            if len(bound) > 128:
                # bound the handle map (and this loop) under hot-set
                # churn: stale handles are zeroed above, then dropped —
                # their registry series stay at 0; re-entering the
                # top-K re-binds the same series (idempotent keying)
                for key in [k for k in bound if k not in live_keys]:
                    del bound[key]
        self._hot_names = names

    def run(self) -> Iterator[StreamItem]:
        raise NotImplementedError

    @property
    def children(self) -> list["ExecOperator"]:
        return []

    def metrics(self) -> dict[str, float]:
        return {}

    def display(self, indent: int = 0, with_metrics: bool = False) -> str:
        """This operator and its inputs, one indented line each; with
        ``with_metrics`` each line carries the operator's metrics (the
        plan ``explain(analyze=True)`` prints)."""
        line = "  " * indent + self._label()
        if with_metrics:
            m = self.metrics()
            if m:
                parts = ", ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in m.items()
                )
                line += f"  [{parts}]"
        return "\n".join(
            [line] + [c.display(indent + 1, with_metrics) for c in self.children]
        )

    def _label(self) -> str:
        return type(self).__name__


def _noting_names(resolve, names: dict):
    """``resolve`` that also records each gid's display key in ``names``."""
    if resolve is None:
        return None

    def run(gids):
        out = resolve(gids)
        names.update(zip([int(g) for g in gids], out))
        return out

    return run
