"""Cluster worker process entry point (counterpart of
``denormalized_tpu/cluster/worker.py``).

``python -m denormalized_tpu_torch.cluster.worker --spec <file> --worker <i>
--store <dir> --restore-epoch <E|none> --seq <k> --out <file>
[--gen <g>] [--abort-floor <E>]``

``--gen`` is this worker's incarnation number (bumped by the
coordinator at every spawn, full or partial) — it rides the exchange
hello so peers distinguish a reconnecting sender from a reborn one.
``--abort-floor`` is the highest epoch the coordinator ever aborted (or
committed) before this incarnation: the merger drops stale barrier
markers at or below it, which is what makes replayed frames from
surviving peers safe to consume verbatim.

One worker = one engine process running BOTH halves of the split query
(cluster/split.py): an **ingest thread** drives the partition-subset
pipeline into the exchange router, and the **main thread** drives the
keyed half from the edge merger into the worker's sink.  A **control
thread** speaks JSON-lines to the coordinator (barriers in,
acks/heartbeats/EOS out).

Checkpoint protocol (worker side): a barrier command either enters the
stream through the source's in-band poll (ingest alive) or — after
ingest EOS — persists the final offsets directly; the keyed half
commits the epoch to the worker's own store when the aligned Marker
drains at its root, then acks.  Once the whole worker is done, the
control thread keeps servicing barriers (persist final offsets, commit,
ack) until the coordinator says stop, so the cluster's cut can keep
advancing while stragglers finish.  The cluster-committed epoch lives
coordinator-side (meta/commits.jsonl); a worker's local commit is only
a proposal until every worker acked it.

Exactly-once output: the sink tags every row with the in-flight epoch
(committed+1) and announces the restored epoch first — transactional
truncate-on-restore, applied per worker slot and clipped by
``cluster/reader.py``.

Device: the keyed half runs where the job's ``engine`` overrides say,
``EngineConfig``'s ``cuda`` by default; without a card that raises, as
``Context()`` does.  The ``eos`` report carries the worker's device and
its kernels' launch counters.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

import numpy as np

from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.cluster.exchange import (
    EdgeMerger,
    ExchangeClient,
    ExchangeServer,
)
from denormalized_tpu_torch.cluster.runtime import (
    ExchangeRouter,
    ExchangeSourceExec,
    replace_scan_source,
)
from denormalized_tpu_torch.cluster.spec import ClusterSpec, resolve_job
from denormalized_tpu_torch.cluster.split import ExchangeScan, split_keyed


def sock_path(workdir: str, worker: int) -> str:
    return os.path.join(workdir, "sock", f"exch_{worker}.sock")


def ctrl_sock_path(workdir: str) -> str:
    return os.path.join(workdir, "sock", "ctrl.sock")


class PinnedCheckpointCoordinator:
    """Factory for a CheckpointCoordinator that restores at exactly the
    cluster-committed epoch the coordinator dictates — a worker's own
    (possibly newer, never cluster-acked) local commit record is
    overridden, its stale epochs GC'd by the base machinery."""

    def __new__(cls, backend, pin_epoch: int | None):
        from denormalized_tpu_torch.state.checkpoint import CheckpointCoordinator

        class _Pinned(CheckpointCoordinator):
            def _select_restore_epoch(
                self, committed, history, commit_corrupt=False
            ):
                if pin_epoch is None:
                    return None  # fresh cluster: ignore any leftovers
                ok, why = self._verify_epoch(pin_epoch)
                if not ok:
                    raise StateError(
                        f"cluster-committed epoch {pin_epoch} failed "
                        f"verification in this worker's store: {why}"
                    )
                return pin_epoch

        return _Pinned(backend)


class _ControlClient:
    """JSON-lines control channel to the coordinator."""

    def __init__(self, path: str, worker_id: int) -> None:
        self.worker_id = worker_id
        deadline = time.monotonic() + 30.0
        last = None
        while time.monotonic() < deadline:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(path)
                self._sock = s
                break
            except OSError as e:
                s.close()
                last = e
                time.sleep(0.05)
        else:
            raise StateError(f"control connect failed: {last}")
        self._wlock = threading.Lock()
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self.send({"ev": "hello", "worker": worker_id})

    def send(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        with self._wlock:
            try:
                self._sock.sendall(data)
            except OSError:
                # coordinator died: the worker is an orphan — exit; the
                # next coordinator incarnation respawns everything
                os._exit(3)

    def recv(self) -> dict | None:
        line = self._rfile.readline()
        if not line:
            return None
        return json.loads(line)


class WorkerRuntime:
    """Shared mutable state between the three worker threads."""

    def __init__(self, spec: ClusterSpec, args) -> None:
        self.spec = spec
        self.args = args
        self.worker_id = args.worker
        self.lock = threading.Lock()
        self.ingest_done = False
        self.keyed_done = False
        self.offsets_persisted: set[int] = set()
        self.committed: set[int] = set()
        self.src_exec = None
        self.coord = None
        self.ctrl: _ControlClient | None = None
        self.merger = None
        self.barrier_q: list[int] = []  # consumed by the source poll
        self.stop_event = threading.Event()
        self.ingest_finished = threading.Event()
        self.rows_emitted = 0
        self.errors: list[str] = []

    # -- barrier plumbing -------------------------------------------------
    def poll_barrier(self) -> int | None:
        """The source's in-band poll.  The source persists its offsets for
        the epoch it takes here, so the epoch counts as persisted: a later
        after-EOS path must not overwrite them with the FINAL offsets (the
        window holds its marker until its next input, which may come after
        ingest ended — the keyed snapshot would then miss rows the final
        offsets claim)."""
        with self.lock:
            if self.barrier_q:
                epoch = self.barrier_q.pop(0)
                self.offsets_persisted.add(epoch)
                return epoch
        return None

    def persist_offsets_once(self, epoch: int) -> None:
        with self.lock:
            if epoch in self.offsets_persisted or self.src_exec is None:
                return
            self.offsets_persisted.add(epoch)
        self.src_exec.persist_final_offsets(epoch)

    def commit_and_ack(self, epoch: int) -> None:
        with self.lock:
            if epoch in self.committed:
                return
            self.committed.add(epoch)
        self.coord.commit(epoch)
        self.ctrl.send({"ev": "ack", "epoch": epoch})

    def _commit_if_keyed_done(self, epoch: int) -> None:
        """Commit+ack an already-persisted epoch iff the keyed half can
        no longer carry its marker.  The keyed_done check runs AFTER the
        offsets persist (callers guarantee that order): either this
        check sees keyed_done=True and commits, or on_keyed_done's sweep
        — which runs after keyed_done is set — sees the epoch in
        offsets_persisted and commits; the ``committed`` set keeps the
        overlap idempotent.  Checking keyed_done BEFORE persisting would
        reopen the lost-epoch race (both paths could miss)."""
        with self.lock:
            keyed_done = self.keyed_done
        if keyed_done and self.coord is not None:
            self.commit_and_ack(epoch)

    def on_abort(self, epoch: int) -> None:
        """Control thread: the coordinator aborted in-flight epoch
        ``epoch`` (a peer died before acking it; the number is never
        reused).  Drop it from the pending barrier queue so the marker
        never enters the stream here, and raise the merger's abort
        floor so markers already in flight from peers unwind instead of
        aligning."""
        with self.lock:
            if epoch in self.barrier_q:
                self.barrier_q.remove(epoch)
            # taken in-band already: its marker unwinds at the merger, and
            # the keyed-done sweep must not commit it either
            self.offsets_persisted.discard(epoch)
        if self.merger is not None:
            self.merger.abort_to(epoch)
        if self.coord is not None:
            self.coord.note_aborted(epoch)

    def on_barrier_cmd(self, epoch: int) -> None:
        """Control thread: route one barrier command."""
        with self.lock:
            ingest_done = self.ingest_done
            if not ingest_done:
                self.barrier_q.append(epoch)
        if not ingest_done or self.coord is None:
            return  # in-band: the keyed Marker path commits+acks
        self.persist_offsets_once(epoch)
        self._commit_if_keyed_done(epoch)

    def on_ingest_done(self) -> None:
        """Ingest thread exit: any barrier still queued (raced the EOS)
        persists final offsets here so its epoch can still commit —
        and commits it NOW if the keyed half is already done (the
        marker can no longer flow, and no later event would)."""
        with self.lock:
            self.ingest_done = True
            pending, self.barrier_q = self.barrier_q, []
        self.ingest_finished.set()
        for e in pending:
            if self.coord is not None:
                self.persist_offsets_once(e)
                self._commit_if_keyed_done(e)
        # otherwise the commit+ack happens when the keyed half sees the
        # marker from the other edges (alignment guarantees it), or on
        # on_keyed_done's sweep for epochs persisted here

    def on_marker(self, epoch: int) -> None:
        """Keyed thread: aligned marker drained at the worker root."""
        if self.coord is None:
            return
        with self.lock:
            ingest_done = self.ingest_done
        if ingest_done:
            self.persist_offsets_once(epoch)
        self.commit_and_ack(epoch)

    def on_keyed_done(self) -> None:
        """Keyed thread exit.  Sweep epochs persisted while the merger
        was returning: their markers never materialized, and the control
        thread's _commit_if_keyed_done may have read keyed_done=False.
        keyed_done is set BEFORE the sweep and the control thread checks
        it AFTER persisting, so the two paths can never both miss; the
        ``committed`` set keeps the overlap idempotent."""
        with self.lock:
            self.keyed_done = True
            pending = sorted(self.offsets_persisted - self.committed)
        for e in pending:
            if self.coord is not None:
                self.commit_and_ack(e)


class _EpochTaggedJsonlSink:
    """Per-worker emission sink, epoch-tagged for exactly-once reading
    (tools/soak.py read_emissions protocol)."""

    def __init__(self, path: str, runtime: WorkerRuntime, schema) -> None:
        from denormalized_tpu_torch.physical.simple_execs import _py

        self._py = _py
        self._f = open(path, "a", buffering=1)
        self._rt = runtime
        self._names = schema.without_internal().names
        self._announced = False

    def _announce(self) -> None:
        coord = self._rt.coord
        self._f.write(json.dumps({
            "event": "restored",
            "epoch": (coord.restored_epoch or 0) if coord else None,
        }) + "\n")
        self._announced = True

    def write(self, batch: RecordBatch) -> None:
        if not self._announced:
            self._announce()
        coord = self._rt.coord
        ep = (coord.committed_epoch or 0) + 1 if coord else None
        user = batch.select(
            [n for n in self._names if batch.schema.has(n)]
        ).materialized()
        names = user.schema.names
        py = self._py
        for i in range(user.num_rows):
            rec = {n: py(user.columns[j][i]) for j, n in enumerate(names)}
            if ep is not None:
                rec["ep"] = ep
            self._f.write(json.dumps(rec) + "\n")
        self._rt.rows_emitted += batch.num_rows

    def close(self) -> None:
        """Idempotent: SinkExec closes at EOS and the worker's teardown
        may close again."""
        if self._f.closed:
            return
        if not self._announced:
            self._announce()
        self._f.write(json.dumps({
            "event": "done", "rows": self._rt.rows_emitted,
        }) + "\n")
        self._f.close()


class _CountSink:
    """Bench-mode sink: rows counted, nothing written per row."""

    def __init__(self, path: str, runtime: WorkerRuntime) -> None:
        self._path = path
        self._rt = runtime
        self._t0 = time.perf_counter()
        self._closed = False

    def write(self, batch: RecordBatch) -> None:
        self._rt.rows_emitted += batch.num_rows

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with open(self._path, "a", buffering=1) as f:
            f.write(json.dumps({
                "event": "done",
                "rows": self._rt.rows_emitted,
                "wall_s": round(time.perf_counter() - self._t0, 4),
            }) + "\n")


def _device_report(device) -> dict:
    """Where this worker's keyed half ran and how often it launched each
    kernel: the process-wide launch counters of the hand kernels' wrappers
    (a wrapper counts only the launches it makes on the card) and the
    scatter path's steps.  A diagnostic riding the ``eos`` report."""
    import torch

    from denormalized_tpu_torch.ops import compact_slot, dense_window
    from denormalized_tpu_torch.ops import merge_partials
    from denormalized_tpu_torch.parallel import sharded_state

    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return {
        "device": str(device),
        "dense_window_launches": dense_window.dense_window_launches,
        "merge_partials_launches": merge_partials.merge_partials_launches,
        "compact_slot_launches": compact_slot.compact_slot_launches,
        "scatter_steps": sharded_state.scatter_steps,
    }


def run_worker(args) -> int:
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.api.context import Context, EngineConfig
    from denormalized_tpu_torch.common.schema import DataType
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.logical.optimizer import optimize
    from denormalized_tpu_torch.physical.base import EndOfStream, Marker
    from denormalized_tpu_torch.physical.simple_execs import SourceExec
    from denormalized_tpu_torch.planner.planner import Planner
    from denormalized_tpu_torch.runtime import faults
    from denormalized_tpu_torch.state.checkpoint import assign_node_ids, walk
    from denormalized_tpu_torch.state.lsm import initialize_global_state_backend
    from denormalized_tpu_torch.state.tiering import attach_spill

    with open(args.spec) as f:
        spec = ClusterSpec.from_json(f.read())
    wid, n = args.worker, spec.n_workers
    # n workers share the host: each takes its share of the cores for
    # torch's intra-op threads (the host-side ops, and the plain versions
    # on the CPU), instead of n processes each spinning one per core;
    # DENORMALIZED_WORKER_TORCH_THREADS overrides it on a host shared with
    # other jobs
    import torch

    torch.set_num_threads(
        int(os.environ.get("DENORMALIZED_WORKER_TORCH_THREADS") or 0)
        or max(1, (os.cpu_count() or 1) // n))
    if spec.fault_plan:
        faults.arm(spec.fault_plan)
    job = resolve_job(spec)

    config = EngineConfig()
    for k, v in (job.get("engine") or {}).items():
        config.set(k, v)
    # the exchange REQUIRES authoritative watermarks on every edge
    config.partition_watermarks = True
    checkpointing = args.restore_epoch != "off"
    if checkpointing:
        config.state_backend_path = args.store
        config.checkpoint = True
    if spec.metrics_jsonl:
        config.metrics_jsonl_path = os.path.join(
            spec.workdir, "obs", f"w{wid}_seq{args.seq}.jsonl"
        )
        config.metrics_jsonl_interval_s = 0.5
    rt = WorkerRuntime(spec, args)
    ctrl = _ControlClient(ctrl_sock_path(spec.workdir), wid)
    rt.ctrl = ctrl
    exporters = None
    server = None
    try:
        # the job's engine device, else EngineConfig's "cuda": without it
        # Context() raises, and the coordinator is told why (a worker never
        # falls back to the CPU)
        ctx = Context(config)
        # -- plan: build, optimize, split, subset -------------------------
        ds = ctx.from_source(job["source"])
        ds = job["pipeline"](ds)
        reg = obs.current_registry() if config.metrics_enabled \
            else obs.disabled_registry()
        with obs.bound_registry(reg):
            plan = optimize(
                lp.Sink(ds.logical_plan(), None),
                getattr(config, "optimizer", True),
            )
        # partial recovery needs checkpointing (there is nothing to pin
        # a lone respawn to without cluster commits) — reader batches
        # are then provenance-stamped so peers can ledger deliveries
        # per partition (cluster/runtime.py PART_COL)
        partial = bool(spec.partial_recovery) and checkpointing
        pin_epoch = (
            0 if args.restore_epoch in ("none", "off")
            else int(args.restore_epoch)
        )
        sq = split_keyed(plan)
        subset = replace_scan_source(
            sq.ingest_logical, wid, n, stamp=partial
        )

        # -- exchange -----------------------------------------------------
        with obs.bound_registry(reg):
            server = ExchangeServer(
                wid, n, sock_path(spec.workdir, wid), sq.exchange_schema,
                partial=partial, last_commit=pin_epoch,
            )
            clients = {
                dst: ExchangeClient(
                    wid, dst, sock_path(spec.workdir, dst),
                    gen=args.gen, restore_epoch=pin_epoch,
                    partial=partial,
                    replay_buffer_bytes=spec.replay_buffer_bytes,
                    reconnect_deadline_s=spec.rejoin_timeout_s,
                )
                for dst in range(n) if dst != wid
            }
        merger = EdgeMerger(server)
        if args.abort_floor:
            merger.abort_to(args.abort_floor)
        rt.merger = merger

        # -- physical halves ---------------------------------------------
        sink = (
            _CountSink(args.out, rt) if spec.sink == "count"
            else _EpochTaggedJsonlSink(args.out, rt, plan.schema)
        )
        keyed_logical = sq.keyed_builder(
            ExchangeScan(
                sq.exchange_schema,
                lambda: ExchangeSourceExec(sq.exchange_schema, merger, wid),
            )
        )
        # re-point the rebuilt Sink node at the worker's sink object
        sink_node = keyed_logical
        while not isinstance(sink_node, lp.Sink):
            sink_node = sink_node.children[0]
        sink_node.sink = sink
        with obs.bound_registry(reg):
            planner = Planner(config)
            ingest_root = planner.create_physical_plan(sq.ingest_logical)
            keyed_root = planner.create_physical_plan(keyed_logical)
            exporters = obs.start_exporters(config, registry=reg)

        # -- checkpoint wiring -------------------------------------------
        coord = None
        spill = None
        state_keys: dict[str, str] = {}
        src_exec = next(
            op for op in walk(ingest_root) if isinstance(op, SourceExec)
        )
        rt.src_exec = src_exec
        if checkpointing:
            backend = initialize_global_state_backend(args.store)
            pin = (
                None if args.restore_epoch in ("none", "off")
                else int(args.restore_epoch)
            )
            with obs.bound_registry(reg):
                coord = PinnedCheckpointCoordinator(backend, pin)
                rt.coord = coord
                # spill BEFORE checkpoint wiring (tier maps rebuild
                # through the adapter, same order as the executor)
                spill = attach_spill(keyed_root, ctx)
                ing_ids = assign_node_ids(ingest_root)
                src_exec.enable_cluster_checkpointing(
                    ing_ids[id(src_exec)], coord, rt.poll_barrier
                )
                state_keys["offsets"] = f"offsets_{ing_ids[id(src_exec)]}"
                key_ids = assign_node_ids(keyed_root)
                for op in walk(keyed_root):
                    hook = getattr(op, "enable_checkpointing", None)
                    if hook is not None:
                        hook(key_ids[id(op)], coord, None)
                        ckpt = getattr(op, "_ckpt", None)
                        if ckpt is not None and ckpt[1].startswith(
                            ("window_", "session_", "udafwin_", "join_")
                        ):
                            state_keys.setdefault("keyed", ckpt[1])

        # -- control thread ----------------------------------------------
        def redial_after_eos(client) -> None:
            rt.ingest_finished.wait()
            try:
                client.redial_after_eos()
            except Exception as e:  # dnzlint: allow(broad-except) not swallowed — reported to the coordinator as a cluster fallback, then the worker exits nonzero (fail-stop)
                # the edge's tail cannot reach the reborn peer: only the
                # full cut is sound
                ctrl.send({"ev": "error", "msg": f"redial: {e!r}",
                           "fallback": "cluster"})
                os._exit(1)

        def ctrl_loop():
            while True:
                msg = ctrl.recv()
                if msg is None:
                    os._exit(3)  # coordinator vanished
                cmd = msg.get("cmd")
                if cmd == "barrier":
                    try:
                        rt.on_barrier_cmd(int(msg["epoch"]))
                    except StateError as e:
                        ctrl.send({"ev": "error", "msg": str(e)})
                        os._exit(1)
                elif cmd == "abort":
                    rt.on_abort(int(msg["epoch"]))
                elif cmd == "committed":
                    # cluster commit: prune replay buffers (senders) and
                    # stale barrier snapshots (receiver ledgers)
                    ep = int(msg["epoch"])
                    server.note_commit(ep)
                    for c in clients.values():
                        c.note_commit(ep)
                elif cmd == "rejoin":
                    # a peer was reborn: once this worker's ingest has
                    # ended (no send will fail and redial any more), replay
                    # the edge's buffered tail to the new incarnation
                    peer = int(msg["worker"])
                    if partial and peer in clients:
                        threading.Thread(
                            target=redial_after_eos, args=(clients[peer],),
                            name="cluster-redial", daemon=True,
                        ).start()
                elif cmd == "stop":
                    rt.stop_event.set()
                    return

        threading.Thread(
            target=ctrl_loop, name="cluster-ctrl", daemon=True
        ).start()

        def hb_loop():
            # liveness signal independent of barrier traffic: with
            # checkpointing off (bench mode) acks never flow, and the
            # coordinator's liveness timeout would otherwise declare a
            # long healthy stream wedged
            while not rt.stop_event.wait(timeout=5.0):
                ctrl.send({"ev": "hb"})

        threading.Thread(
            target=hb_loop, name="cluster-hb", daemon=True
        ).start()

        key_dtypes = []
        for k in sq.key_columns:
            f_ = sq.exchange_schema.field(k)
            if f_.dtype in (DataType.STRING, DataType.STRUCT,
                            DataType.LIST):
                key_dtypes.append("obj")
            else:
                key_dtypes.append(np.dtype(f_.dtype.to_numpy()).str)
        if args.gen > 0 and partial:
            # rejoin handshake fault site: an injected StateError here
            # surfaces as a failed rejoin — the coordinator's
            # rejoin_timeout_s / budget machinery must degrade to the
            # full-cluster restart, never wedge
            faults.inject("cluster.rejoin", key=f"w{wid}")
        # the outbound edges' handshakes come before "ready": a respawn
        # reports its rejoin once it holds each surviving receiver's dedup
        # ledger, so a peer that dies after the rejoin is one this
        # incarnation already deduplicated against (the JAX worker
        # connects after "ready", and a peer killed in between meets a
        # sender with no ledger)
        for c in clients.values():
            c.connect()
        ctrl.send({
            "ev": "ready",
            "restored_epoch": (
                (coord.restored_epoch or 0) if coord is not None else None
            ),
            "gen": args.gen,
            # partition subset echo: the coordinator cross-checks the
            # respawn landed on exactly the dead worker's partitions
            "partitions": subset.global_partition_ids(),
            "n_partitions": subset.n_partitions_total,
            "state_keys": state_keys,
            "key_columns": sq.key_columns,
            "key_dtypes": key_dtypes,
        })

        # -- run ----------------------------------------------------------
        router = ExchangeRouter(
            ingest_root, sq.key_columns, wid, n, clients, server
        )
        ingest_err: list[BaseException] = []

        def ingest_main():
            try:
                with obs.bound_registry(reg):
                    router.run()
            except BaseException as e:  # dnzlint: allow(broad-except) supervisor boundary: the error is re-dispatched to the coordinator as data and the process exits nonzero — fail-stop, never silent
                ingest_err.append(e)
                msg = {"ev": "error", "msg": f"ingest: {e!r}"}
                if getattr(e, "cluster_fallback", False):
                    # partial recovery provably cannot absorb this
                    # (replay gap, reconnect budget, unstamped rows):
                    # tell the coordinator to take the full restart
                    msg["fallback"] = "cluster"
                ctrl.send(msg)
                os._exit(1)
            finally:
                rt.on_ingest_done()

        ing_t = threading.Thread(
            target=ingest_main, name="cluster-ingest", daemon=True
        )
        t_run0 = time.perf_counter()
        ing_t.start()

        with obs.bound_registry(reg):
            it = keyed_root.run()
            try:
                for item in it:
                    if isinstance(item, Marker):
                        rt.on_marker(item.epoch)
                    elif isinstance(item, EndOfStream):
                        break
            finally:
                it.close()
        rt.on_keyed_done()
        ing_t.join(timeout=30.0)
        sink.close()  # idempotent; covers a stream torn down pre-EOS
        ctrl.send({
            "ev": "eos",
            **_device_report(ctx.device),
            "rows": rt.rows_emitted,
            "rows_in": router.rows_routed,
            "ingest_wall_s": round(router.wall_s, 4),
            # ingest start → keyed-half EOS: the full pipeline wall
            # (the exchange's bounded queues let a small feed finish
            # ingest long before the keyed half drains — rows/s must
            # not be read off the ingest wall alone)
            "worker_wall_s": round(time.perf_counter() - t_run0, 4),
        })
        # keep servicing barriers until the coordinator releases us
        rt.stop_event.wait(timeout=spec.liveness_timeout_s)
        return 0
    except Exception as e:
        import traceback

        tb = traceback.format_exc(limit=8)
        try:
            msg = {"ev": "error", "msg": f"{e!r}\n{tb}"}
            if getattr(e, "cluster_fallback", False):
                msg["fallback"] = "cluster"
            ctrl.send(msg)
        except Exception:  # dnzlint: allow(broad-except) the control channel may be the thing that failed; the nonzero exit below still surfaces the crash to the coordinator
            pass
        raise
    finally:
        if server is not None:
            server.stop()
        if exporters is not None:
            exporters.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="denormalized_tpu_torch.cluster.worker")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument(
        "--restore-epoch", default="off",
        help="'off' (no checkpointing), 'none' (fresh), or the pinned "
        "cluster-committed epoch",
    )
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument(
        "--gen", type=int, default=0,
        help="incarnation number for the exchange hello (bumped by the "
        "coordinator at every spawn of this worker)",
    )
    ap.add_argument(
        "--abort-floor", type=int, default=0,
        help="highest aborted-or-committed epoch before this "
        "incarnation; barrier markers at or below it are dropped",
    )
    args = ap.parse_args(argv)
    return run_worker(args)


if __name__ == "__main__":
    sys.exit(main())
