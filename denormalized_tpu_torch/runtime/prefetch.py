"""Pipelined multi-core ingest: one prefetch worker per partition.

Each :class:`PrefetchWorker` thread owns one :class:`PartitionReader`
(and therefore that reader's own native client connection — the native
Kafka client is single-threaded per object, so per-worker ownership is
what makes the fetch loops independent) and runs the full
fetch → native decode → ``RecordBatch`` assembly loop off the consumer
thread.  The ctypes foreign calls (``kc_fetch``, the native JSON/Avro
parse) drop the GIL for their native portion, so N workers overlap
network wait and decode across cores; ``tests/test_torch_prefetch.py``
pins that property with a concurrency test.

Completed batches land in one shared ready queue that the consumer
(:class:`~denormalized_tpu_torch.physical.simple_execs.SourceExec`) drains —
each item already carries the reader's offset snapshot (taken right
after the read, so barrier persistence reflects only yielded batches)
and its canonical timestamps.  The queue itself is unbounded; the bound
is a per-worker ``Semaphore(depth)`` released only after the consumer
has fully processed the item downstream.  That makes backpressure the
bounded per-partition buffer (a double buffer at ``depth=2``: one batch
being consumed, one being assembled) rather than the reader's poll
cadence, and it means one partition's catch-up burst can never occupy
another partition's budget the way a single shared bounded queue could.

Reader-side activity is tracked on the worker (single-writer slots) so
watermark idleness judgments never depend on when the consumer got
around to processing a partition's batches:

- ``pending``         — enqueued-but-unconsumed rowful batches exist;
- ``enq_wall``        — wall clock of the last rowful enqueue;
- ``first_read_done`` — the first ``read()`` has RETURNED (before that,
  the partition's backlog is unknown, not absent);
- ``caught_up``       — the reader's own backlog report
  (``PartitionReader.caught_up()``): ``False`` means the source KNOWS
  more data is already at the broker, so the partition must never be
  idle-excluded even while a fetch/decode is in flight (the soak-found
  hole behind SOAK_KAFKA's short first window: a partition mid-way
  through a large catch-up fetch looked idle to every consumer-side
  clock).  ``None`` (reader has no backlog knowledge) falls back to the
  wall-clock judgment.

Idleness needs the reader's own evidence, which the JAX package's pump
does not ask for: a partition counts as quiet only for as long as its
reader has itself seen nothing, from the start of the first read after
its last rows that came back empty to the return of its latest read.  A
reader that has not run (a loaded host, or a consumer holding the GIL)
keeps a stale stamp and a stale ``caught_up`` while its rows pile up at
the broker; judging it by the consumer's clock let one partition's
catch-up carry the watermark past the others' rows and close windows
short (``tests/test_torch_idle_watermark.py``'s stalled-reader test).

Supervision: a worker whose reader dies with a transient error
(``SourceError``/``StateError``) does not kill the query.  The supervisor
restarts it with exponential backoff + jitter, rebuilding the reader via
the source's per-partition factory and seeking it to the snapshot of the
LAST batch this worker successfully ENQUEUED — everything at or before
that offset is already in the ready queue or consumed, everything after
it was lost with the crash and gets re-read, so a restart can neither
replay rows the consumer saw nor drop rows it never will (the same
offset-snapshot contract checkpoint restore uses).  A bounded restart
budget (per-worker and pump-global) escalates to a structured
:class:`PrefetchRestartExhausted` carrying partition, attempt count, and
last error; restart counts surface in ``SourceExec.metrics()`` and each
restart emits a ``tracing.span`` event.

Copy of ``denormalized_tpu/runtime/prefetch.py``.  Registry scoping is
per query: a worker captures ``obs.current_registry()`` where it is built
(under its query's binding) and re-enters it on its own thread, so a
supervised rebuild's binds land in the same query's series.
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
import time
from typing import Callable, Iterator

from denormalized_tpu_torch.common.errors import SourceError, StateError
from denormalized_tpu_torch.runtime.tracing import logger, span
from denormalized_tpu_torch.state.tiering import (
    backpressure_pause as _backpressure_pause,
    pressure_engaged as _pressure_engaged,
)


class PrefetchRestartExhausted(SourceError):
    """A partition's worker failed past its restart budget: the structured
    query failure the supervisor escalates to."""

    def __init__(self, partition: int, attempts: int, last_error):
        super().__init__(
            f"partition {partition}: prefetch worker failed permanently "
            f"after {attempts} restart(s): {last_error}"
        )
        self.partition = partition
        self.attempts = attempts
        self.last_error = last_error


class _RestartBudget:
    """Shared cap on restarts across all of one pump's workers.  Tokens
    are refunded when a worker's restart streak heals (sustained healthy
    operation), so the budget bounds failure RATE, not lifetime count —
    a long-lived stream with occasional healed hiccups must not converge
    to guaranteed death."""

    def __init__(self, n: int):
        self._n = n
        self._cap = n
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self._n <= 0:
                return False
            self._n -= 1
            return True

    def refund(self, n: int) -> None:
        with self._lock:
            self._n = min(self._cap, self._n + n)

    def remaining(self) -> int:
        with self._lock:
            return self._n


class PrefetchWorker:
    """One partition's fetch+decode loop on its own thread."""

    def __init__(
        self,
        idx: int,
        reader,
        out_q: queue_mod.Queue,
        done: threading.Event,
        *,
        depth: int = 2,
        read_timeout_s: float = 0.1,
        reader_factory: Callable[[], object] | None = None,
        restart_budget: int = 5,
        global_budget: _RestartBudget | None = None,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        heal_after_s: float = 60.0,
        source_name: str = "default",
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.idx = idx
        self.reader = reader
        self._q = out_q
        self._done = done
        self._depth = depth
        self._slots = threading.Semaphore(depth)
        self._read_timeout_s = read_timeout_s
        # -- supervision ---------------------------------------------------
        self._reader_factory = reader_factory
        self._restart_budget = restart_budget
        self._global_budget = global_budget or _RestartBudget(restart_budget)
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._heal_after_s = heal_after_s
        # jitter RNG seeded per partition: restart timing never depends on
        # a shared global RNG another thread may be draining
        self._jitter = random.Random(0x5EED ^ (idx * 7919))
        #: lifetime restart count (observability) — budget decisions use
        #: the CURRENT STREAK, which heals after heal_after_s of crash-
        #: free operation (with the global tokens refunded): the budget
        #: bounds systemic failure, not total uptime
        self.restarts = 0
        self._streak = 0
        self._restart_wall = 0.0
        self.last_error: str | None = None
        self.backoff_total_s = 0.0
        #: offset snapshot of the last batch successfully ENQUEUED — the
        #: rebuild-on-restart seek point (everything <= it is in the queue
        #: or consumed; everything past it died with the old reader)
        self._last_snap: dict | None = None
        #: decode-fallback rows accumulated by readers this worker has
        #: RETIRED across restarts — the replacement reader's counter
        #: starts at 0, and the perf-cliff metric must not reset with it.
        #: Folded under _swap_lock so a metrics read can never observe
        #: the count doubled or dropped mid-swap.
        self.retired_decode_fallback_rows = 0
        self.retired_salvaged_rows = 0
        self._swap_lock = threading.Lock()
        # single-writer activity slots (worker writes enq_*, consumer
        # writes deq_) — see module docstring
        self.enq_rowful = 0
        self.deq_rowful = 0
        self.enq_wall = time.monotonic()
        # (start of the first empty read since the last rows, or None;
        # the latest read's return): the reader's own evidence of quiet,
        # one tuple so a consumer never reads half an update
        self.quiet_marks = (None, self.enq_wall)
        self.first_read_done = False
        self.caught_up: bool | None = None
        self.finished = False
        self._thread: threading.Thread | None = None
        # registry instruments: queue depth (enq - deq rowful batches; at
        # the depth limit the worker is backpressure-blocked in
        # _acquire_slot) and the supervised-restart counter.  The gauge
        # value is a single store, so the worker (enqueue) and consumer
        # (dequeue) updating it without a lock can only be one batch
        # stale, never torn.  Labels carry the SOURCE too: a join runs
        # two pumps whose partition indexes collide, and sharing a
        # series across them would break the single-writer contract.
        from denormalized_tpu_torch import obs

        # captured binding: instruments bound FROM THE WORKER THREAD (a
        # supervised rebuild constructing a fresh Kafka reader binds its
        # consumer-lag gauge there) land in the query-scoped registry this
        # worker was built under
        self._obs_reg = obs.current_registry()
        self._obs_depth = obs.gauge(
            "dnz_prefetch_queue_depth",
            source=source_name, partition=str(idx),
        )
        self._obs_restarts = obs.counter(
            "dnz_prefetch_restarts_total",
            source=source_name, partition=str(idx),
        )
        # handoff dwell: observed by the CONSUMER at dequeue (see
        # PrefetchPump._strip) from the enqueue stamp riding each item —
        # the doctor's "is the consumer thread the bottleneck" signal
        self._obs_dwell = obs.histogram(
            "dnz_prefetch_queue_dwell_ms",
            source=source_name, partition=str(idx),
        )

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run,
            daemon=True,
            name=f"prefetch-{self.idx}",
        )
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # -- consumer side ----------------------------------------------------
    def consumed(self, rowful: bool) -> None:
        """Release the item's buffer slot AFTER downstream processed it —
        the slot is the backpressure unit, so it must cover the full
        consume, not just the dequeue."""
        if rowful:
            self.deq_rowful += 1
            self._obs_depth.set(self.enq_rowful - self.deq_rowful)
        self._slots.release()

    def quiet_s(self) -> float:
        """Seconds the reader itself has seen no rows: from the start of
        the first empty read after its last rows to the return of its
        latest read (0 while it has not come back empty since)."""
        since, last = self.quiet_marks
        return 0.0 if since is None else last - since

    def activity(self) -> tuple[bool, float, bool, bool]:
        """(pending, last_activity_wall, first_read_done, may_judge_idle)
        for the partition-watermark tracker.  The activity wall is the
        later of the last rowful enqueue and ``now - quiet_s()``: the
        tracker's clock can find the partition idle only once the reader
        has seen the idle timeout's worth of nothing."""
        return (
            self.enq_rowful > self.deq_rowful,
            max(self.enq_wall, time.monotonic() - self.quiet_s()),
            self.first_read_done,
            self.caught_up is not False,
        )

    def reader_quiet(self, min_quiet_s: float = 0.0) -> bool:
        """True when the READER side shows no sign of data in flight:
        first read returned, nothing enqueued-but-unconsumed, the reader
        does not report known backlog, and it has itself seen no rows
        for ``min_quiet_s``.  A finished partition is quiet permanently."""
        if self.finished:
            return True
        return (
            self.first_read_done
            and self.enq_rowful <= self.deq_rowful
            and self.caught_up is not False
            and self.quiet_s() >= min_quiet_s
        )

    # -- worker side ------------------------------------------------------
    def _acquire_slot(self) -> bool:
        while not self._done.is_set():
            if self._slots.acquire(timeout=0.1):
                return True
        return False

    def _restartable(self, err: BaseException) -> bool:
        """Transient engine errors restart; anything else (programming
        errors, interpreter shutdown) surfaces to the consumer verbatim.
        Without a factory there is nothing to rebuild from."""
        return (
            self._reader_factory is not None
            and isinstance(err, (SourceError, StateError))
        )

    def _rebuild_reader(self) -> None:
        new = self._reader_factory()
        if self._last_snap is not None:
            new.offset_restore(self._last_snap)
        # dnzlint: allow(unguarded) single-writer field: only the supervisor thread (this method's caller) ever rebinds self.reader; _swap_lock exists to keep the metric fold + swap glitch-free for concurrent *_total() readers
        old = self.reader
        with self._swap_lock:
            # fold + swap atomically w.r.t. decode_fallback_total(): no
            # ordering of the two writes alone is glitch-free (one gives
            # a transient drop, the other a transient double count)
            fallback = getattr(old, "decode_fallback_rows", None)
            if callable(fallback):
                try:
                    self.retired_decode_fallback_rows += int(fallback())
                except Exception:  # dnzlint: allow(broad-except) best-effort metrics fold off a CRASHED reader — its counter is worth carrying over, never worth failing the restart for
                    pass
            # same carry for salvage-skipped rows: a restart must not
            # RESET the silent-data-loss counter
            self.retired_salvaged_rows += int(
                getattr(old, "salvaged_rows", 0) or 0
            )
            self.reader = new
        # caught_up stays False (set when the crash was detected) until
        # the rebuilt reader's first fetch reports real backlog state
        close = getattr(old, "close", None)
        if callable(close):
            # free the crashed reader's native client now, not at GC —
            # a flapping partition would otherwise hold one dead broker
            # connection per restart
            try:
                close()
            except Exception:  # dnzlint: allow(broad-except) best-effort release of a connection that already died — the crash error, not the close error, is the story
                pass

    def decode_fallback_total(self) -> int:
        """Current + retired decode-fallback rows, glitch-free across a
        supervised reader swap."""
        with self._swap_lock:
            return (
                self.reader.decode_fallback_rows()
                + self.retired_decode_fallback_rows
            )

    def salvaged_total(self) -> int:
        """Current + retired salvage-skipped (undecodable, dropped)
        rows, glitch-free across a supervised reader swap."""
        with self._swap_lock:
            return (
                int(getattr(self.reader, "salvaged_rows", 0) or 0)
                + self.retired_salvaged_rows
            )

    def _run(self) -> None:
        # the end-of-stream sentinel is the consumer's ONLY liveness
        # signal from this worker: it must be guaranteed by the
        # outermost frame, so nothing that runs before the supervised loop
        # (the registry re-entry, a failed import) can kill the thread
        # sentinel-less and wedge the consumer in get()
        try:
            from denormalized_tpu_torch import obs

            with obs.bound_registry(self._obs_reg):
                self._run_supervised()
        finally:
            self.finished = True
            self._q.put((self.idx, None, None, 0.0))

    def _run_supervised(self) -> None:
        err: BaseException | None = None
        while True:
            if err is not None:
                if self._done.is_set():
                    return  # shutting down: swallow, nobody is reading
                if not self._restartable(err):
                    self._q.put(err)  # surfaced by the consumer
                    return
                if (
                    self._streak >= self._restart_budget
                    or not self._global_budget.take()
                ):
                    self._q.put(PrefetchRestartExhausted(
                        self.idx, self.restarts, err
                    ))
                    return
                self.restarts += 1
                self._obs_restarts.add(1)
                self._streak += 1
                self._restart_wall = time.monotonic()
                # jitter INSIDE the clamp: backoff_max_s is a hard cap
                # a caller can tune against watermark/idle timeouts
                delay = min(
                    self._backoff_max_s,
                    self._backoff_base_s * (2 ** (self._streak - 1))
                    * (1.0 + 0.25 * self._jitter.random()),
                )
                self.backoff_total_s += delay
                logger.warning(
                    "prefetch worker %d: %s — restart %d/%d in %.2fs "
                    "(resume from %s)",
                    self.idx, err, self._streak, self._restart_budget,
                    delay, self._last_snap,
                )
                if self._done.wait(delay):
                    return
                err = None
                try:
                    with span(
                        "prefetch.restart",
                        partition=self.idx, attempt=self.restarts,
                    ):
                        self._rebuild_reader()
                except BaseException as e:  # dnzlint: allow(broad-except) not swallowed — the supervisor re-dispatches: restartable errors re-enter the budgeted backoff, the rest surface via the queue on the next loop pass
                    # rebuild failed (e.g. broker still down): another
                    # crash — loops back into the budgeted backoff
                    err = e
                    self.last_error = f"{type(e).__name__}: {e}"
                    continue
            try:
                self._run_reader()
                return  # clean EOS (or shutdown)
            except BaseException as e:  # dnzlint: allow(broad-except) not swallowed — the supervisor loop classifies err: non-restartable errors are enqueued for the consumer to re-raise, restartable ones restart
                err = e
                self.last_error = f"{type(e).__name__}: {e}"
                # rows past _last_snap died with the reader and WILL
                # be re-read: the partition must read as known-backlog
                # (never idle-judgeable) for the whole backoff/rebuild
                # window, or the watermark advances over the lost rows
                # and the re-read arrives "late" — silent loss by the
                # very mechanism meant to prevent it
                self.caught_up = False

    def _run_reader(self) -> None:
        # dnzlint: allow(unguarded) single-writer field: the supervisor thread running this loop is the only writer of self.reader (rebound in _rebuild_reader between _run_reader calls, never during one)
        reader = self.reader
        probe = getattr(reader, "caught_up", None)
        if not callable(probe):
            probe = None
        if self._last_snap is None:
            self._last_snap = reader.offset_snapshot()
        while not self._done.is_set():
            if self._streak and (
                time.monotonic() - self._restart_wall >= self._heal_after_s
            ):
                # crash-free for the heal interval: the streak resets and
                # its global tokens come back — the next independent
                # hiccup gets a full budget instead of inheriting debt
                # from hours-old healed failures
                self._global_budget.refund(self._streak)
                self._streak = 0
            if _pressure_engaged():
                # end-of-line backpressure from the state tier: spill
                # could not keep accounted state under the hard ceiling,
                # so the PUMP slows down — one bounded pause per read (a
                # throttle, never a halt: rows must keep trickling or the
                # watermark stalls and the pressure can never clear).
                # Broker-side backlog absorbs what we stop fetching.
                _backpressure_pause()
            t_read = time.monotonic()
            b = reader.read(timeout_s=self._read_timeout_s)
            since = self.quiet_marks[0]
            if b is not None and b.num_rows:
                since = None
            elif since is None:
                since = t_read
            self.quiet_marks = (since, time.monotonic())
            self.first_read_done = True
            if b is None:
                return  # partition exhausted (or reader died cleanly)
            if probe is not None:
                cu = probe()
                if cu is not None or self.caught_up is not False:
                    # a None probe result (no fetch yet / mid-reconnect)
                    # must NOT release a crash-time known-backlog pin —
                    # only REAL backlog knowledge may
                    self.caught_up = cu
            elif self.caught_up is False and b.num_rows:
                # probe-less reader delivered rows again: the crash-time
                # pin is served (the re-read reached the consumer path);
                # fall back to wall-clock idleness judgment
                self.caught_up = None
            if b.num_rows:
                # stamp BEFORE the (possibly blocking) slot acquire:
                # while waiting for the consumer the partition has
                # pending work and must read as active
                self.enq_wall = time.monotonic()
                self.enq_rowful += 1
                self._obs_depth.set(self.enq_rowful - self.deq_rowful)
            snap = reader.offset_snapshot()
            if not self._acquire_slot():
                return  # shutdown won
            # the enqueue stamp rides the item: the consumer observes
            # queue dwell (enqueue → dequeue) at _strip time
            self._q.put((self.idx, snap, b, time.perf_counter()))
            self._last_snap = snap


class PrefetchPump:
    """N prefetch workers merged into one ready queue."""

    def __init__(
        self,
        readers,
        *,
        queue_budget: int = 64,
        depth: int | None = None,
        read_timeout_s: float = 0.1,
        reader_factories: list | None = None,
        restart_budget: int = 5,
        global_restart_budget: int | None = None,
        restart_heal_s: float = 60.0,
        source_name: str = "default",
    ) -> None:
        if depth is None:
            # split the aggregate budget across partitions; never below a
            # double buffer, never absurdly deep (in-flight batches widen
            # the watermark skew the consumer must reconcile)
            depth = max(2, min(16, queue_budget // max(1, len(readers))))
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._done = threading.Event()
        if global_restart_budget is None:
            # generous enough for independent per-partition hiccups, small
            # enough that a systemic failure (broker gone for good) cannot
            # retry forever across N partitions
            global_restart_budget = max(8, 2 * len(readers))
        self._global_budget = _RestartBudget(global_restart_budget)
        # None (the documented sentinel) disables supervision; an empty
        # LIST from a buggy partition_factories() must hit the length
        # guard below, not silently disable restarts for every partition
        factories = (
            [None] * len(readers) if reader_factories is None
            else reader_factories
        )
        if len(factories) != len(readers):
            raise ValueError(
                f"{len(factories)} reader factories for "
                f"{len(readers)} readers"
            )
        self.workers = [
            PrefetchWorker(
                i, r, self._q, self._done,
                depth=depth, read_timeout_s=read_timeout_s,
                reader_factory=factories[i],
                restart_budget=restart_budget,
                global_budget=self._global_budget,
                heal_after_s=restart_heal_s,
                source_name=source_name,
            )
            for i, r in enumerate(readers)
        ]
        self.depth = depth

    def start(self) -> "PrefetchPump":
        for w in self.workers:
            w.start()
        return self

    def stop(self, join_timeout_s: float | None = 5.0) -> list[int]:
        """Shut the pump down for real: signal done, release every
        worker's buffer slots (a worker blocked in ``_acquire_slot`` wakes
        immediately instead of on its next 0.1s poll), join each worker,
        and drain the ready queue so buffered batches/exceptions don't
        outlive the query.  Returns the indexes of stragglers — workers
        still alive after the join timeout (wedged in a native call) —
        after logging them."""
        self._done.set()
        for w in self.workers:
            # over-releasing is harmless: the done flag gates the loop
            w._slots.release(w._depth)
        deadline = (
            None if join_timeout_s is None
            else time.monotonic() + join_timeout_s
        )
        stragglers = []
        for w in self.workers:
            t = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            w.join(t)
            if w._thread is not None and w._thread.is_alive():
                stragglers.append(w.idx)
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        if stragglers:
            logger.warning(
                "prefetch stop: %d worker(s) still alive after %.1fs "
                "join timeout: %s",
                len(stragglers), join_timeout_s or 0.0, stragglers,
            )
        return stragglers

    def restart_stats(self) -> dict:
        """Supervisor observability, aggregated into SourceExec.metrics()."""
        per = {w.idx: w.restarts for w in self.workers if w.restarts}
        return {
            "restarts": sum(per.values()),
            "restarted_partitions": len(per),
            "per_partition": per,
            "last_errors": {
                w.idx: w.last_error
                for w in self.workers if w.last_error
            },
            "global_budget_remaining": self._global_budget.remaining(),
        }

    def _strip(self, item):
        """Normalize a queue item for consumers: observe the handoff
        dwell (enqueue stamp → now) for rowful batches and strip the
        stamp, so every caller keeps seeing ``(idx, snap, batch)``.
        Exceptions and legacy 3-tuples (tests enqueue them directly)
        pass through untouched."""
        if isinstance(item, tuple) and len(item) == 4:
            idx, snap, b, t_enq = item
            if b is not None and b.num_rows and t_enq:
                w = self.workers[idx]
                if w._obs_dwell:
                    w._obs_dwell.observe(
                        (time.perf_counter() - t_enq) * 1e3
                    )
            return idx, snap, b
        return item

    def get(self):
        return self._strip(self._q.get())

    def get_live(self, timeout_s: float = 30.0):
        """Blocking get with a liveness backstop.  A live worker
        guarantees an item at least every read-timeout (even a quiet
        topic enqueues empty heartbeats), so a queue starved past
        ``timeout_s`` while some worker thread has DIED without its
        end-of-stream sentinel can never heal — raise a structured
        SourceError naming the partitions instead of blocking the
        consumer forever.  Workers that are alive but slow (a 30s
        native-recv stall against a sick broker) just log and keep
        waiting."""
        while True:
            try:
                return self._strip(self._q.get(timeout=timeout_s))
            except queue_mod.Empty:
                dead = [
                    w.idx for w in self.workers
                    if not w.finished
                    and w._thread is not None
                    and not w._thread.is_alive()
                ]
                if dead:
                    raise SourceError(
                        f"prefetch worker(s) {dead} died without an "
                        f"end-of-stream sentinel (ready queue starved "
                        f"for {timeout_s:.0f}s)"
                    ) from None
                logger.warning(
                    "prefetch ready queue starved for %.0fs — still "
                    "waiting on live worker(s) for partition(s) %s",
                    timeout_s,
                    [w.idx for w in self.workers if not w.finished],
                )

    def consumed(self, idx: int, rowful: bool) -> None:
        self.workers[idx].consumed(rowful)

    def activity(self, idx: int) -> tuple[bool, float, bool, bool]:
        return self.workers[idx].activity()

    def quiet(self, min_quiet_s: float = 0.0) -> bool:
        """True when EVERY partition is reader-side quiet, each reader
        having seen no rows for ``min_quiet_s`` — the gate for the
        source-level idle hint, so a consumer stall (compile, GC)
        followed by an empty heartbeat can never declare idleness over
        rows that are already fetched, known to be at the broker, or
        not yet read by a reader that did not run."""
        return all(w.reader_quiet(min_quiet_s) for w in self.workers)

    def drain(
        self,
        total_rows: int | None = None,
        deadline: float | None = None,
    ) -> Iterator:
        """Utility consumer loop (bench / tests): yield (idx, snap,
        batch) for every rowful batch, releasing slots as it goes, until
        ``total_rows`` rows were seen or every worker finished.  Raises
        the first worker exception; raises TimeoutError once
        ``time.monotonic()`` passes ``deadline`` — checked on every
        dequeued item (empty heartbeats included) AND while waiting, so
        a wedged stream fails visibly instead of blocking forever."""
        finished = 0
        seen = 0
        n = len(self.workers)
        while finished < n:
            if deadline is None:
                item = self.get()
            else:
                while True:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"prefetch drain stalled at {seen} rows"
                        )
                    try:
                        item = self._strip(self._q.get(timeout=1.0))
                        break
                    except queue_mod.Empty:
                        continue
            if isinstance(item, BaseException):
                raise item
            idx, snap, batch = item
            if batch is None:
                finished += 1
                continue
            rowful = bool(batch.num_rows)
            try:
                if rowful:
                    seen += batch.num_rows
                    yield idx, snap, batch
            finally:
                self.consumed(idx, rowful)
            if total_rows is not None and seen >= total_rows:
                return
