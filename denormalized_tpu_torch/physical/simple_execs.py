"""Source / projection / filter / sink operators (host-side, vectorized).

Counterpart of ``denormalized_tpu/physical/simple_execs.py``.  A bounded
source, or a live one of a single partition, is driven round-robin
in-thread; a live source of several partitions runs one prefetch worker a
partition (``runtime/prefetch.py``) feeding one ready queue.  The source
injects a checkpoint :class:`Marker` after the batch during which a barrier
arrived, persisting the offsets of the batches it has YIELDED, and ends
with EndOfStream.  A source of several partitions sends per-partition
watermarks (:class:`_PartitionWatermarks`, ``EngineConfig.
partition_watermarks``); a live source with ``source_idle_timeout_ms``
also sends idle hints (:class:`_IdleTracker`).  With record lineage on,
the source tags its sampled rows at ingest.  In a cluster worker the
barriers come from the coordinator (:meth:`SourceExec.
enable_cluster_checkpointing`), and a barrier that lands after the source's
EOS persists the final offsets outside the stream
(:meth:`SourceExec.persist_final_offsets`).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Iterator

import numpy as np

from denormalized_tpu_torch import obs
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical.expr import AliasExpr, Column, Expr
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    WM_ANNOUNCE,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.sources.base import Source

#: per-process ordinal per source NAME: two sources sharing a name (a join
#: of two default-named MemorySources) must not share metric series — the
#: registry dedups by (name, labels).  The first claimant of a name keeps
#: it bare; later ones get ``name#2``, ``#3``... in plan-build order.
_SOURCE_SERIES_ORDINALS: dict[str, int] = {}


def _source_series_label(name: str) -> str:
    n = _SOURCE_SERIES_ORDINALS.get(name, 0) + 1
    _SOURCE_SERIES_ORDINALS[name] = n
    return name if n == 1 else f"{name}#{n}"


def _ts_of(batch: RecordBatch) -> np.ndarray:
    return np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)


def _close_readers(readers) -> None:
    """Release each reader's connection (a Kafka reader's native client)
    when its stream ends or is closed."""
    for r in readers:
        close = getattr(r, "close", None)
        if callable(close):
            close()


class _IdleTracker:
    """Idle-source detection shared by both SourceExec drive loops: rows
    re-arm it; after ``timeout_ms`` without rows it yields ONE
    WatermarkHint at the max canonical timestamp seen.

    ``quiet`` (optional) is a reader-side gate: the hint carries the
    GLOBAL max timestamp, so on the multi-partition prefetch path it
    must never fire while any partition still has rows enqueued or
    known backlog at the broker — the consumer-side clock alone reads
    "idle" after any long consumer stall (first-batch build, GC) even
    though the stalled period's batches are sitting in the queue, and
    the resulting hint would close windows the slower partition still
    owes rows to."""

    def __init__(self, timeout_ms: int, quiet: Callable[[], bool] | None = None) -> None:
        self.timeout_ms = timeout_ms
        self._last_rows_wall = time.monotonic()
        self._max_ts: int | None = None
        self._sent = False
        self._quiet = quiet

    def observe_rows(self, batch: RecordBatch) -> None:
        self._last_rows_wall = time.monotonic()
        self._sent = False
        bmax = int(np.max(_ts_of(batch)))
        if self._max_ts is None or bmax > self._max_ts:
            self._max_ts = bmax

    def maybe_hint(self) -> WatermarkHint | None:
        if (
            self._sent
            or self._max_ts is None
            or (time.monotonic() - self._last_rows_wall) * 1000
            < self.timeout_ms
        ):
            return None
        if self._quiet is not None and not self._quiet():
            return None
        self._sent = True
        return WatermarkHint(self._max_ts)


class _PartitionWatermarks:
    """Per-partition watermark aggregation: the source-level watermark is
    the MIN over each partition's own max-of-batch-min-ts.  The merged
    stream's legacy rule (operator watermark = global max of batch
    min-ts) races ahead on whichever partition drains fastest — during
    replay/catch-up that drops the slower partitions' entire backlog as
    late.  Exclusions from the min:

    - finished partitions (bounded EOS or a dead unbounded reader): their
      constraint lifts permanently;
    - partitions idle past ``timeout_ms`` (Flink-style idleness) — they
      re-enter on new rows, and the monotonic emission guard means a
      resumed partition's OLD rows may drop late, exactly as if idleness
      had been declared by the idle-hint machinery.

    ``observe``/``advance`` return a kind="partition" WatermarkHint only
    when the min strictly advances."""

    #: first-read hold bound, as a multiple of the idle timeout: a reader
    #: that still hasn't RETURNED from its first read after this long
    #: stops holding the watermark and falls back to idle exclusion —
    #: a reader wedged in connect/seek must not stall the stream forever.
    FIRST_READ_GRACE_MULT = 4

    def __init__(self, n: int, timeout_ms: int | None = None, activity=None) -> None:
        self._wm: list[int | None] = [None] * n
        self._last_rows = [time.monotonic()] * n
        self._finished = [False] * n
        self._timeout_s = (
            timeout_ms / 1000.0 if timeout_ms is not None else None
        )
        self._emitted: int | None = None
        self._born = time.monotonic()
        # activity(idx) -> (has_pending, last_rowful_produce_wall,
        # first_read_done, may_judge_idle): on the threaded path idleness
        # is judged by what the READER produced, not by when the consumer
        # got around to processing it — a burst of one partition's
        # catch-up batches ahead in the SHARED queue otherwise makes the
        # other partition look idle while its backlog is already
        # enqueued, excludes it from the min, and late-drops that
        # backlog.  first_read_done separates "quiet topic" from "still
        # starting": a reader that has not yet RETURNED from its first
        # read holds the min (its initial backlog is unknown, not
        # absent).  may_judge_idle is False while the reader KNOWS it has
        # broker-side backlog (PartitionReader.caught_up() is False): a
        # partition mid-way through a large catch-up fetch has nothing
        # enqueued and a stale produce stamp, yet idle-excluding it
        # late-drops the very rows that fetch is carrying.
        self._activity = activity

    def observe(self, idx: int, batch: RecordBatch) -> WatermarkHint | None:
        bmin = int(np.min(_ts_of(batch)))
        if self._wm[idx] is None or bmin > self._wm[idx]:
            self._wm[idx] = bmin
        self._last_rows[idx] = time.monotonic()
        return self.advance()

    def finish(self, idx: int) -> WatermarkHint | None:
        self._finished[idx] = True
        return self.advance()

    def advance(self) -> WatermarkHint | None:
        now = time.monotonic()
        vals = []
        for i, (w, lr, fin) in enumerate(
            zip(self._wm, self._last_rows, self._finished)
        ):
            if fin:
                continue
            if self._activity is not None:
                pending, produced, first_read_done, may_judge_idle = (
                    self._activity(i)
                )
                if not first_read_done:
                    # still starting: backlog unknown, hold — but only up
                    # to a bounded multiple of the idle timeout; past it
                    # the stuck reader is excluded like an idle one
                    if self._timeout_s is None or (
                        now - self._born
                        < self.FIRST_READ_GRACE_MULT * self._timeout_s
                    ):
                        return None
                    continue
                lr = max(lr, produced)
                if pending or not may_judge_idle:
                    # enqueued-but-unprocessed rows, or reader-reported
                    # broker backlog (catch-up fetch in flight): never idle
                    lr = now
            idle = (
                self._timeout_s is not None
                and now - lr >= self._timeout_s
            )
            if w is None:
                if idle:
                    continue  # never-produced idle partition: excluded
                return None  # a live partition hasn't spoken yet
            if idle:
                continue
            vals.append(w)
        if not vals:
            return None
        m = min(vals)
        if self._emitted is None or m > self._emitted:
            self._emitted = m
            return WatermarkHint(m, kind="partition")
        return None


class SourceExec(ExecOperator):
    """Leaf operator: drives every partition of a source and merges their
    batches into one ordered stream.

    Bounded sources (and a live source of one partition) round-robin
    in-thread; a live source of several partitions gets one prefetch
    worker a partition feeding one ready queue (the reference's tokio
    task per Kafka partition, kafka_stream_read.rs:87-298).  Checkpoint
    barriers are injected in-band between batches when an orchestrator is
    attached."""

    def __init__(
        self,
        source: Source,
        *,
        queue_size: int = 64,
        idle_timeout_ms: int | None = None,
        partition_watermarks: bool | str = "auto",
    ) -> None:
        self.source = source
        self.schema = source.schema
        self._queue_size = queue_size
        self._idle_timeout_ms = idle_timeout_ms
        self._partition_watermarks = partition_watermarks
        self._barrier_poll: Callable[[], int | None] | None = None
        # batch_rows_min/max: the size range of rowful batches (a live
        # source's fetch coalescing and splitting set it)
        self._metrics = {"rows_out": 0, "batches_out": 0,
                         "batch_rows_min": 0, "batch_rows_max": 0}
        self._readers: list | None = None
        self._pump = None  # live prefetch pump (supervisor metrics)
        self._ckpt = None  # (CheckpointCoordinator, node_id)
        # per partition, the offset snapshot after its last YIELDED batch
        self._yielded_offsets: list | None = None
        import weakref

        # the registry this operator was BUILT under: run-time binds (pump
        # workers, rebuilt Kafka readers) land in the same query-scoped
        # registry whichever thread drives the generator
        self._obs_reg = obs.current_registry()
        self._obs_source_label = _source_series_label(str(source.name))
        self._obs_rows_out = obs.counter(
            "dnz_op_rows_out_total", op="source",
            source=self._obs_source_label,
        )
        # registry view of the decode-fallback count (the authoritative
        # count stays on the readers); a weakref, so the registry never
        # pins a finished query's operator graph
        ref = weakref.ref(self)
        obs.gauge_fn(
            "dnz_decode_fallback_rows",
            lambda: (
                op.metrics().get("decode_fallback_rows", 0)
                if (op := ref()) is not None else 0
            ),
            source=self._obs_source_label,
        )

    def set_barrier_source(self, poll: Callable[[], int | None]) -> None:
        self._barrier_poll = poll

    # -- checkpointing (offset persistence mirrors BatchReadMetadata,
    # kafka_stream_read.rs:49-65,275-289; restore :110-140) -------------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        from denormalized_tpu_torch.state.checkpoint import make_barrier_poll

        self._ckpt = (coord, node_id)
        base_poll = make_barrier_poll(orch.register(f"src_{node_id}"))

        def poll():
            epoch = base_poll()
            if epoch is not None:
                self._persist_offsets(epoch)
            return epoch

        self._barrier_poll = poll

    def enable_cluster_checkpointing(
        self, node_id: str, coord, poll_epoch: Callable[[], int | None]
    ) -> None:
        """Cluster-mode wiring (``cluster/worker.py``): barriers come from
        the coordinator's control channel instead of a local Orchestrator —
        the same in-band injection and offset persistence, but the epoch
        NUMBER is cluster-global so every worker's cut shares one key
        suffix."""
        self._ckpt = (coord, node_id)

        def poll():
            epoch = poll_epoch()
            if epoch is not None:
                self._persist_offsets(epoch)
            return epoch

        self._barrier_poll = poll

    def persist_final_offsets(self, epoch: int) -> None:
        """Persist the (final) yielded offsets for ``epoch`` OUTSIDE the
        stream: a cluster worker calls this when a barrier lands after
        this source reached EOS, so the cluster cut still records every
        partition at its end position instead of omitting the finished
        worker (which would replay its whole subset on restore)."""
        self._persist_offsets(epoch)

    def _persist_offsets(self, epoch: int) -> None:
        from denormalized_tpu_torch.state.checkpoint import put_json

        if self._ckpt is None or self._yielded_offsets is None:
            return
        coord, node_id = self._ckpt
        # offsets of batches actually YIELDED downstream — on the prefetch
        # path reader positions race ahead (prefetched batches still sit
        # in the queue), so the barrier must not persist live reader state
        put_json(
            coord,
            f"offsets_{node_id}",
            epoch,
            {"epoch": epoch, "partitions": list(self._yielded_offsets)},
        )

    def _restore_offsets(self, readers) -> None:
        from denormalized_tpu_torch.common.errors import StateError
        from denormalized_tpu_torch.state.checkpoint import get_json

        if self._ckpt is None:
            return
        coord, node_id = self._ckpt
        snap = get_json(coord, f"offsets_{node_id}")
        if snap is None:
            return
        parts = snap.get("partitions", [])
        if len(parts) != len(readers):
            raise StateError(
                f"checkpoint has {len(parts)} partitions but source "
                f"{self.source.name!r} now has {len(readers)} — partition "
                "layout must match across restarts"
            )
        for r, s in zip(readers, parts):
            r.offset_restore(s)

    def _label(self):
        return f"SourceExec({self.source.name})"

    def metrics(self):
        m = dict(self._metrics)
        # fetch and decode seconds of the readers in use (a Kafka reader
        # times both on its own thread)
        readers = (
            [w.reader for w in self._pump.workers]
            if self._pump is not None else (self._readers or [])
        )
        m["fetch_s"] = sum(getattr(r, "fetch_s", 0.0) for r in readers)
        m["decode_s"] = sum(getattr(r, "decode_s", 0.0) for r in readers)
        # per-partition Python-decode fallback counts and salvage-skipped
        # rows, aggregated: a schema that silently routes to the slower
        # decoder, or poison records dropped to keep progressing, must be
        # observable.  The pump's CURRENT readers count (a supervised
        # restart swaps a worker's reader; retired readers' counts are
        # carried on the worker)
        if self._pump is not None:
            m["decode_fallback_rows"] = sum(
                w.decode_fallback_total() for w in self._pump.workers
            )
            m["salvaged_rows"] = sum(
                w.salvaged_total() for w in self._pump.workers
            )
            rs = self._pump.restart_stats()
            m["prefetch_restarts"] = rs["restarts"]
            m["prefetch_restarted_partitions"] = rs["restarted_partitions"]
            if rs["last_errors"]:
                m["prefetch_last_errors"] = dict(rs["last_errors"])
        else:
            m["decode_fallback_rows"] = sum(
                r.decode_fallback_rows() for r in (self._readers or [])
            )
            m["salvaged_rows"] = sum(
                int(getattr(r, "salvaged_rows", 0) or 0)
                for r in (self._readers or [])
            )
        return m

    def _maybe_barrier(self) -> Iterator[StreamItem]:
        if self._barrier_poll is not None:
            epoch = self._barrier_poll()
            if epoch is not None:
                yield Marker(epoch)

    def _partition_wm_tracker(self, n_readers: int, activity=None):
        """Resolve partition-watermark mode: 'auto' enables it for any
        multi-partition source whose liveness is guaranteed — bounded
        (finished partitions leave the min) or unbounded WITH an idle
        timeout (quiet partitions leave the min).  An unbounded source
        with no idleness policy keeps legacy max-of-min semantics: a
        silent partition would otherwise stall the watermark forever."""
        on = self._partition_watermarks is True or (
            self._partition_watermarks == "auto"
            and n_readers > 1
            and (
                not self.source.unbounded
                or self._idle_timeout_ms is not None
            )
        )
        if not on:
            return None
        return _PartitionWatermarks(
            n_readers, self._idle_timeout_ms, activity=activity
        )

    def _count(self, batch: RecordBatch) -> None:
        m, n = self._metrics, batch.num_rows
        if n:
            m["batch_rows_min"] = min(m["batch_rows_min"] or n, n)
            m["batch_rows_max"] = max(m["batch_rows_max"], n)
        m["rows_out"] += n
        m["batches_out"] += 1
        self._obs_rows_out.add(n)

    def run(self) -> Iterator[StreamItem]:
        # reader construction binds instruments (Kafka consumer-lag
        # gauges): scope them to this operator's captured registry
        with obs.bound_registry(self._obs_reg):
            readers = self.source.partitions()
        self._readers = readers
        self._restore_offsets(readers)
        self._yielded_offsets = [r.offset_snapshot() for r in readers]
        if not self.source.unbounded or len(readers) == 1:
            try:
                yield from self._run_round_robin(readers)
            finally:
                _close_readers(readers)
        else:
            yield from self._run_prefetch(readers)

    def _run_round_robin(self, readers) -> Iterator[StreamItem]:
        """Deterministic round-robin over bounded partitions (also the
        single-reader live path, which needs idle hints like the prefetch
        path — bounded sources get the EOS flush instead)."""
        idle = (
            _IdleTracker(
                self._idle_timeout_ms,
                # a reader that KNOWS it has backlog (caught_up False)
                # blocks the idle hint; None (no backlog knowledge) keeps
                # the wall-clock judgment
                quiet=lambda: all(r.caught_up() is not False for r in readers),
            )
            if self.source.unbounded and self._idle_timeout_ms is not None
            else None
        )
        pwm = self._partition_wm_tracker(len(readers))
        if pwm is not None:
            yield WatermarkHint(WM_ANNOUNCE, kind="partition")
        live = list(enumerate(readers))
        while live:
            nxt = []
            for i, r in live:
                b = r.read()
                if b is None:
                    if pwm is not None and (h := pwm.finish(i)):
                        yield h
                    continue
                nxt.append((i, r))
                if b.num_rows:
                    self._count(b)
                    if idle is not None:
                        idle.observe_rows(b)
                    if self._dr_lineage is not None:
                        # sampled record lineage: tag rows with the
                        # reader's own post-batch offset snapshot
                        self._dr_lineage.ingest(
                            self._obs_source_label, i,
                            r.offset_snapshot(), b,
                        )
                    yield b
                    self._yielded_offsets[i] = r.offset_snapshot()
                    if pwm is not None and (h := pwm.observe(i, b)):
                        yield h
                else:
                    if idle is not None and (h := idle.maybe_hint()):
                        yield h
                    if pwm is not None and (h := pwm.advance()):
                        yield h
                yield from self._maybe_barrier()
            live = nxt
        yield EOS

    def _run_prefetch(self, readers) -> Iterator[StreamItem]:
        """Live multi-partition: one prefetch worker per partition runs
        the full fetch → decode → assembly loop off this thread (the
        ctypes foreign calls release the GIL for their native portion, so
        workers overlap across cores).  Each ready item carries the
        reader's offset snapshot taken right after the read, so barrier
        persistence reflects only yielded batches; backpressure is the
        per-partition bounded buffer inside the pump, released only after
        downstream fully processed the batch.  Closing the stream stops
        the workers and closes every reader's native client."""
        from denormalized_tpu_torch.runtime.prefetch import PrefetchPump

        with obs.bound_registry(self._obs_reg):
            pump = PrefetchPump(
                readers,
                queue_budget=self._queue_size,
                # per-partition rebuild hooks: with these the pump
                # SUPERVISES worker crashes (restart + seek to the last
                # enqueued offset) instead of failing the query on the
                # first transient error
                reader_factories=self.source.partition_factories(),
                source_name=self._obs_source_label,
            )
        self._pump = pump
        finished = 0
        # idle-source watermark hints: live readers deliver EMPTY batches
        # on read timeouts even when the topic is quiet, so idleness is
        # measured from the last ROWFUL batch (wall clock), gated on
        # reader-side quiescence so a consumer stall can never declare
        # idleness over data already in flight.  One hint per idle
        # period; rows re-arm it.
        idle = (
            _IdleTracker(
                self._idle_timeout_ms,
                quiet=lambda: pump.quiet(self._idle_timeout_ms / 1000.0),
            )
            if self._idle_timeout_ms is not None
            else None
        )
        pwm = self._partition_wm_tracker(len(readers), activity=pump.activity)
        if pwm is not None:
            yield WatermarkHint(WM_ANNOUNCE, kind="partition")
        pump.start()
        try:
            while finished < len(readers):
                # liveness-checked get: a worker that died without its
                # sentinel surfaces as a structured error instead of
                # wedging the stream in an untimed queue wait
                item = pump.get_live()
                if isinstance(item, BaseException):
                    raise item
                idx, snap, batch = item
                if batch is None:
                    # per-reader EOS (dead unbounded reader)
                    finished += 1
                    if pwm is not None and (h := pwm.finish(idx)):
                        yield h
                    continue
                self._count(batch)
                if idle is not None:
                    if batch.num_rows:
                        idle.observe_rows(batch)
                    elif h := idle.maybe_hint():
                        yield h
                if self._dr_lineage is not None and batch.num_rows:
                    self._dr_lineage.ingest(
                        self._obs_source_label, idx, snap, batch
                    )
                yield batch
                self._yielded_offsets[idx] = snap
                pump.consumed(idx, bool(batch.num_rows))
                if pwm is not None:
                    h = (
                        pwm.observe(idx, batch)
                        if batch.num_rows
                        else pwm.advance()
                    )
                    if h:
                        yield h
                yield from self._maybe_barrier()
        finally:
            stragglers = set(pump.stop())
            # a worker still inside a native call keeps its client
            _close_readers(
                w.reader for w in pump.workers if w.idx not in stragglers
            )
        yield EOS


class ProjectExec(ExecOperator):
    def __init__(self, input_op: ExecOperator, exprs: list[Expr], schema: Schema):
        self.input_op = input_op
        self.exprs = exprs
        self.schema = schema
        self.bind_obs("project")

    @property
    def children(self):
        return [self.input_op]

    def _label(self):
        return f"ProjectExec({', '.join(e.name for e in self.exprs)})"

    def run(self) -> Iterator[StreamItem]:
        def passthrough_name(e: Expr) -> str | None:
            # validity masks survive projections that are pure column
            # references (possibly aliased); computed exprs get no mask
            while isinstance(e, AliasExpr):
                e = e.inner
            return e.name if isinstance(e, Column) else None

        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                t0 = time.perf_counter()
                self._obs_rows_in.add(item.num_rows)
                cols = [e.eval(item) for e in self.exprs]
                masks = [
                    item.mask(src) if (src := passthrough_name(e)) is not None else None
                    for e in self.exprs
                ]
                out = RecordBatch(self.schema, cols, masks)
                self._note_batch(t0, item.num_rows)
                yield out
            else:
                yield item


class FilterExec(ExecOperator):
    def __init__(self, input_op: ExecOperator, predicate: Expr):
        self.input_op = input_op
        self.predicate = predicate
        self.schema = input_op.schema
        self.bind_obs("filter")

    @property
    def children(self):
        return [self.input_op]

    def _label(self):
        return f"FilterExec({self.predicate!r})"

    def run(self) -> Iterator[StreamItem]:
        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                t0 = time.perf_counter()
                self._obs_rows_in.add(item.num_rows)
                keep = np.asarray(self.predicate.eval(item), dtype=bool)
                out = (
                    item if keep.all()
                    else item.filter(keep) if keep.any()
                    else None
                )
                self._note_batch(t0, item.num_rows)
                if out is not None:
                    yield out
            else:
                yield item


class SinkExec(ExecOperator):
    """Terminal operator driving a sink over the finished stream."""

    def __init__(self, input_op: ExecOperator, sink: "Sink") -> None:
        self.input_op = input_op
        self.sink = sink
        self.schema = input_op.schema
        self.bind_obs("sink")

    @property
    def children(self):
        return [self.input_op]

    def _label(self):
        return f"SinkExec({type(self.sink).__name__})"

    def run(self) -> Iterator[StreamItem]:
        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                # sink.write is this operator's busy time: a slow sink
                # shows up as the bottleneck it is, not as upstream wait
                t0 = time.perf_counter()
                self._obs_rows_in.add(item.num_rows)
                self.sink.write(item)
                self._note_batch(t0, item.num_rows)
            elif isinstance(item, EndOfStream):
                self.sink.close()
            yield item


class Sink:
    def write(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class PrintSink(Sink):
    """stdout sink; strips internal columns like the reference's
    print_stream (datastream.rs:317-339 prints JSON rows minus metadata)."""

    def __init__(self, file=None) -> None:
        self._file = file or sys.stdout

    def write(self, batch: RecordBatch) -> None:
        import json

        # sink = user-facing boundary: columnar columns materialize here
        user = batch.select(batch.schema.without_internal().names).materialized()
        names = user.schema.names
        for i in range(user.num_rows):
            row = {n: _py(user.columns[j][i]) for j, n in enumerate(names)}
            print(json.dumps(row), file=self._file)


def _py(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


class CallbackSink(Sink):
    """Python-callback sink (the PyO3 ``sink_python`` equivalent): calls
    ``fn(batch)`` with internal columns stripped."""

    def __init__(self, fn: Callable[[RecordBatch], None]) -> None:
        self._fn = fn

    def write(self, batch: RecordBatch) -> None:
        # user callback = user-facing boundary: rows may materialize
        self._fn(
            batch.select(batch.schema.without_internal().names).materialized()
        )


class CollectSink(Sink):
    """Collects emitted batches."""

    def __init__(self) -> None:
        self.batches: list[RecordBatch] = []

    def write(self, batch: RecordBatch) -> None:
        self.batches.append(batch)

    def result(self) -> RecordBatch:
        return RecordBatch.concat(self.batches)
