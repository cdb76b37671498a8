"""Worker-side runtime operators: partition subsetting, the exchange
router (ingest half) and the exchange source (keyed half).

Counterpart of ``denormalized_tpu/cluster/runtime.py``.  The router runs
on the ingest thread and only hashes and frames; interning stays with the
keyed half's window operator on the worker's main thread.

The ingest half is the UNMODIFIED single-process pipeline — SourceExec
(prefetch pump, supervised restarts, partition watermarks) plus any
stateless operators — driven by :class:`ExchangeRouter`, which splits
each batch by ``hash(key) % n_workers`` (cluster/hashing.py) and ships
the shards: self-destined rows take the zero-copy loopback, peers get
framed column buffers.  Watermarks piggyback on data frames and
broadcast as explicit frames on advance, so an edge that carries no
rows for a worker still advances its event time; barriers broadcast
in-band on every edge after the data that precedes them.

The keyed half consumes :class:`ExchangeSourceExec` — a leaf operator
yielding merged batches, authoritative ("partition"-kind) watermark
hints at the min over inbound edges, aligned checkpoint markers, and
EOS when every edge finished.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
    WM_ANNOUNCE,
)
from denormalized_tpu_torch.sources.base import PartitionReader, Source
from denormalized_tpu_torch.cluster import framing
from denormalized_tpu_torch.cluster.hashing import bucket_rows, partitions_for

#: batch-constant provenance column stamped at the reader (every batch
#: comes from exactly one partition cursor) and dropped by the router
#: before framing/loopback — receivers ledger delivered rows per
#: (edge, global partition) against it, which is what makes a reborn
#: sender's replay exactly deduplicatable (cluster/exchange.py)
PART_COL = "__dnz_part"


class _StampedReader(PartitionReader):
    """Delegating reader that appends the global-partition provenance
    column to every batch.  Offsets, backlog and decode reporting pass
    through untouched — the stamp is invisible to checkpointing."""

    def __init__(self, inner: PartitionReader, global_pid: int) -> None:
        self._inner = inner
        self._pid = global_pid
        self._field = Field(PART_COL, DataType.INT64, nullable=False)

    def read(self, timeout_s: float | None = None):
        batch = self._inner.read(timeout_s)
        if batch is None:
            return None
        return batch.with_column(
            self._field,
            np.full(batch.num_rows, self._pid, dtype=np.int64),
        )

    def offset_snapshot(self) -> dict:
        return self._inner.offset_snapshot()

    def offset_restore(self, snap: dict) -> None:
        self._inner.offset_restore(snap)

    def decode_fallback_rows(self) -> int:
        return self._inner.decode_fallback_rows()

    def caught_up(self):
        return self._inner.caught_up()


class PartitionSubsetSource(Source):
    """A view of ``inner`` restricted to this worker's static partition
    subset (``partitions_for``): reader ``i`` of the subset is global
    partition ``worker + i * n_workers`` — the one assignment rule the
    offset rescaler inverts (cluster/rescale.py).

    With ``stamp=True`` every reader batch carries ``PART_COL`` (the
    global partition id) for the exchange's rejoin ledgers; the
    declared ``schema`` stays the inner one — the stamp is batch-level
    provenance, invisible to planning."""

    def __init__(
        self, inner: Source, worker: int, n_workers: int,
        stamp: bool = False,
    ) -> None:
        self._inner = inner
        self.worker = worker
        self.n_workers = n_workers
        self.stamp = stamp
        self.name = f"{inner.name}@w{worker}"
        all_readers = inner.partitions()
        self.n_partitions_total = len(all_readers)
        self._pids = partitions_for(
            worker, n_workers, self.n_partitions_total
        )
        self._readers = [
            self._wrap(all_readers[p], p) for p in self._pids
        ]

    def _wrap(self, reader: PartitionReader, pid: int) -> PartitionReader:
        return _StampedReader(reader, pid) if self.stamp else reader

    @property
    def schema(self):
        return self._inner.schema

    @property
    def unbounded(self) -> bool:
        return self._inner.unbounded

    def partitions(self) -> list[PartitionReader]:
        readers, self._readers = self._readers, None
        if readers is None:
            # a second scan of the same source object rebuilds fresh
            # cursors (bounded replay sources support this) — ONE inner
            # scan, then subset, never one scan per subset partition
            all_readers = self._inner.partitions()
            readers = [
                self._wrap(all_readers[p], p) for p in self._pids
            ]
        return readers

    def partition_factories(self):
        inner = self._inner.partition_factories()
        if inner is None:
            return None

        def _stamped_factory(factory, pid):
            return lambda: self._wrap(factory(), pid)

        return [
            _stamped_factory(inner[p], p) for p in self._pids
        ]

    def global_partition_ids(self) -> list[int]:
        return list(self._pids)


class ExchangeRouter:
    """Drives the ingest half and routes its output into the exchange.

    Single-threaded (the worker's ingest thread); owns the outbound
    clients.  ``run()`` returns once the ingest pipeline reached EOS and
    the EOS frames are on every edge."""

    def __init__(
        self,
        ingest_root: ExecOperator,
        key_columns: list[str],
        worker_id: int,
        n_workers: int,
        clients: dict,
        server,
    ) -> None:
        from denormalized_tpu_torch import obs

        self.root = ingest_root
        self.key_columns = key_columns
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.clients = clients  # dst -> ExchangeClient (excludes self)
        self.server = server  # loopback target
        self.wm: int | None = None
        self.source_done = False
        self.rows_routed = 0
        self.wall_s = 0.0
        self._key_idx = [
            ingest_root.schema.index_of(k) for k in key_columns
        ]
        self._obs_rows = obs.counter(
            "dnz_op_rows_out_total", op="exchange_router",
            source=f"w{worker_id}",
        )

    def _broadcast(
        self, frame_bytes: bytes, local_item: tuple,
        kind: str, epoch: int | None = None,
    ) -> None:
        self.server.local_put(local_item)
        for dst in range(self.n_workers):
            if dst == self.worker_id:
                continue
            self.clients[dst].send(frame_bytes, kind, epoch)

    def _route_batch(self, batch: RecordBatch) -> None:
        if batch.num_rows == 0:
            return
        self._obs_rows.add(batch.num_rows)
        self.rows_routed += batch.num_rows
        pid = None
        if batch.schema.has(PART_COL):
            # batch-constant provenance stamp: record it for the rejoin
            # ledgers, then drop it — it never crosses the wire and the
            # keyed half's schema doesn't know it
            pid = int(batch.column(PART_COL)[0])
            batch = batch.select(
                [n for n in batch.schema.names if n != PART_COL]
            )
        if self.n_workers == 1:
            # single worker: every key is ours — skip the hash entirely
            self.server.local_put(("data", batch, self.wm))
            return
        buckets = bucket_rows(
            [batch.columns[i] for i in self._key_idx], self.n_workers
        )
        for dst in range(self.n_workers):  # dnzlint: allow(hot-loop) bounded per-WORKER sweep; the split itself is a vectorized boolean mask per destination
            mask = buckets == dst
            if not mask.any():
                continue
            sub = batch if mask.all() else batch.filter(mask)
            if dst == self.worker_id:
                # the loopback never skips: a reborn worker's own state
                # restored to the same epoch its ingest replays from
                self.server.local_put(("data", sub, self.wm))
                continue
            client = self.clients[dst]
            if pid is not None:
                s = client.take_skip(pid, sub.num_rows)
                if s:
                    # the receiver already holds this prefix from my
                    # previous incarnation — per-partition sequences
                    # are deterministic, so dropping the first s rows
                    # is exact, not heuristic
                    sub = sub.slice(s, sub.num_rows - s)
            if sub.num_rows:
                client.send(
                    framing.encode_data(sub, self.wm, part=pid), "data"
                )

    def run(self) -> None:
        t_start = time.perf_counter()
        try:
            self._run_inner()
        finally:
            self.wall_s = time.perf_counter() - t_start

    def _run_inner(self) -> None:
        for item in self.root.run():
            if isinstance(item, RecordBatch):
                self._route_batch(item)
            elif isinstance(item, WatermarkHint):
                if item.is_announcement:
                    continue  # the merger announces downstream itself
                if self.wm is None or item.ts_ms > self.wm:
                    self.wm = item.ts_ms
                    self._broadcast(
                        framing.encode_wm(self.wm), ("wm", self.wm), "wm"
                    )
            elif isinstance(item, Marker):
                # barriers are per-edge frames, not one shared buffer:
                # while this (reborn) worker's dedup skip is draining,
                # each peer must learn its own residual so its ledger
                # snapshot for this epoch anchors at the barrier's
                # stream position, not at the delivered frontier
                self.server.local_put(("barrier", item.epoch))
                for dst in range(self.n_workers):
                    if dst == self.worker_id:
                        continue
                    client = self.clients[dst]
                    client.send(
                        framing.encode_barrier(
                            item.epoch, skips=client.skip_residual()
                        ),
                        "barrier", item.epoch,
                    )
            elif isinstance(item, EndOfStream):
                break
        self.source_done = True
        self._broadcast(framing.encode_eos(), ("eos",), "eos")
        for c in self.clients.values():
            c.close()


class ExchangeSourceExec(ExecOperator):
    """Leaf operator of the keyed half: merged exchange stream in, engine
    stream items out.  Watermark hints are authoritative per-edge-merged
    minima (kind="partition"), so the keyed operator never advances from
    raw batch timestamps — exchange interleaving across senders would
    race a max-of-min watermark exactly like multi-partition replay
    does."""

    def __init__(self, schema, merger, worker_id: int) -> None:
        from denormalized_tpu_torch import obs

        self.schema = schema
        self.merger = merger
        self.worker_id = worker_id
        self._metrics = {"rows_out": 0, "batches_out": 0}
        self.bind_obs("exchange_source")
        self._obs_rows_out = obs.counter(
            "dnz_op_rows_out_total", op="exchange_source",
            source=f"w{worker_id}",
        )

    def metrics(self):
        return dict(self._metrics)

    def _label(self):
        return f"ExchangeSourceExec(w{self.worker_id})"

    def run(self) -> Iterator[StreamItem]:
        yield WatermarkHint(WM_ANNOUNCE, kind="partition")
        it = iter(self.merger)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                break
            self._note_input_wait(time.perf_counter() - t0)
            kind = item[0]
            if kind == "data":
                batch = item[1]
                self._metrics["rows_out"] += batch.num_rows
                self._metrics["batches_out"] += 1
                self._obs_rows_out.add(batch.num_rows)
                self._note_batch(t0, batch.num_rows)
                yield batch
            elif kind == "wm":
                yield WatermarkHint(item[1], kind="partition")
            elif kind == "barrier":
                yield Marker(item[1])
        yield EOS


def replace_scan_source(
    ingest_logical, worker: int, n_workers: int, stamp: bool = False
) -> PartitionSubsetSource:
    """Swap the (possibly projection-pushed) Scan's source for this
    worker's partition subset.  The plan objects are built fresh inside
    each worker process, so in-place replacement is safe — nothing else
    holds them."""
    from denormalized_tpu_torch.common.errors import PlanError
    from denormalized_tpu_torch.common.schema import Schema
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.logical.expr import Column

    node = ingest_logical
    projects = []
    while not isinstance(node, lp.Scan):
        kids = node.children
        if len(kids) != 1:
            raise PlanError("ingest half must be a unary chain to a Scan")
        if isinstance(node, lp.Project):
            projects.append(node)
        node = kids[0]
    subset = PartitionSubsetSource(
        node.source, worker, n_workers, stamp=stamp
    )
    node.source = subset
    if stamp:
        # the provenance stamp must survive optimizer-pushed
        # projections the same way the canonical timestamp column
        # rides along implicitly (logical/plan.py Project.__init__):
        # ProjectExec rebuilds batches to its expr list, so each
        # Project in the chain passes PART_COL through by reference
        # (Column.eval is name-based against the live batch)
        field = Field(PART_COL, DataType.INT64, nullable=False)
        for proj in projects:
            if not proj.schema.has(PART_COL):
                proj.exprs.append(Column(PART_COL))
                proj.schema = Schema(list(proj.schema) + [field])
    return subset
