"""Exchange plumbing: unix-domain sockets between worker processes.

Counterpart of ``denormalized_tpu/cluster/exchange.py``: the same wire
protocol, replay buffers, rejoin ledgers and fault sites.

Topology: every worker hosts one **server** socket and dials one
**client** connection to every other worker — worker w's keyed operator
therefore has N inbound *edges*: N-1 sockets plus a zero-copy loopback
from its own ingest half.  Frames (cluster/framing.py) flow sender →
receiver only; there is no request/response.

The receive side runs one thread per inbound connection, decoding frames
into a bounded per-edge queue — the queue bound (plus the kernel socket
buffer) IS the exchange's backpressure, exactly like the prefetch
pump's per-partition double buffer.  The :class:`EdgeMerger` is the
single consumer: it merges data across edges, merges **watermarks** as
the min over per-edge watermarks (an edge's watermark advances via
piggybacked data-frame watermarks and explicit wm frames), aligns
**barriers** (an edge that delivered barrier E is not consumed again
until every live edge delivered E — the aligned Chandy-Lamport cut,
same invariant the join operator enforces per-epoch), and collapses to
EOS when every edge reports it.

Failure model: **integrity** violations stay fail-stop (a torn or
corrupt frame kills the worker that observed it — under partial
recovery the coordinator then respawns only that worker), but
**connectivity** failures are survivable when the spec enables
``partial_recovery``: a send on a dead edge buffers-or-backpressures
behind a bounded-exponential-backoff reconnect, a receiver whose peer
vanished marks the edge *down* (``dnz_exchange_edges_down``) and keeps
merging the other edges while the dead peer's watermark holds the min.
Every client keeps a bounded **replay buffer** of frames since the
last cluster-committed barrier (pruned on commit notifications); the
rejoin handshake (hello → resume, cluster/framing.py) picks one of
three replay modes — same-generation tear-heal (resend frames the
receiver never processed), reborn-sender dedup (receiver reports rows
per partition already delivered since the pinned epoch; the router
skips exactly that prefix), or reborn-receiver full replay (resend
everything since the last committed barrier).  Anything the handshake
cannot prove exact — ledger gap, evicted buffer, unstamped batches —
raises a ``SourceError`` tagged ``cluster_fallback`` and the
coordinator falls back to the documented full-cluster restart: graceful
degradation, never a new wedge class (docs/cluster.md#rejoin).

Fault sites ``exchange.connect`` / ``exchange.send`` /
``exchange.recv`` / ``exchange.reconnect`` / ``cluster.replay``
(runtime/faults.py) make every one of those paths reproducible on
demand; ``exchange.send`` and ``cluster.replay`` support ``torn``
rules — the truncated frame is genuinely written before the connection
drops, so the RECEIVER exercises its tear detection, not just the
sender its error path.
"""

from __future__ import annotations

import queue
import socket
import threading
import time

from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.cluster import framing

#: per-edge inbound queue bound (items, mostly data frames): with the
#: socket buffer this bounds memory while a barrier-blocked edge waits
EDGE_QUEUE_ITEMS = 16

_CONNECT_TIMEOUT_S = 30.0

#: bounded exponential backoff for edge reconnects (seconds)
_RECONNECT_BACKOFF_S = (0.05, 1.6)


def cluster_fallback_error(msg: str) -> SourceError:
    """A failure partial recovery cannot absorb exactly — the worker
    reports it with ``fallback="cluster"`` and the coordinator takes
    the documented full-cluster restart instead of a partial respawn."""
    e = SourceError(f"{msg} [cluster-restart-fallback]")
    e.cluster_fallback = True
    return e


class ExchangeClient:
    """One outbound edge: this worker's ingest half → peer ``dst``.

    With ``partial=True`` the edge is *reconnectable*: every frame is
    appended to a bounded replay buffer before it is written (pruned
    when the coordinator announces a cluster commit), a failed write
    triggers bounded-exponential-backoff redial, and the peer's resume
    frame decides what to resend — see the module docstring for the
    three replay modes."""

    def __init__(
        self,
        src: int,
        dst: int,
        sock_path: str,
        gen: int = 0,
        restore_epoch: int = 0,
        partial: bool = False,
        replay_buffer_bytes: int = 64 << 20,
        reconnect_deadline_s: float = 60.0,
    ) -> None:
        from denormalized_tpu_torch import obs

        self.src = src
        self.dst = dst
        self.sock_path = sock_path
        self.gen = int(gen)
        self.restore_epoch = int(restore_epoch)
        self.partial = bool(partial)
        self.reconnect_deadline_s = reconnect_deadline_s
        self.edge = f"{src}->{dst}"
        self._sock: socket.socket | None = None
        # replay buffer: (idx, kind, epoch, frame_bytes) since the last
        # cluster-committed barrier; idx is the frame's position in this
        # sender generation's stream (implicit sequence number)
        self._buf: list[tuple[int, str, int | None, bytes]] = []
        self._buf_bytes = 0
        self._buf_cap = int(replay_buffer_bytes)
        self._buf_lock = threading.Lock()
        self._replay_ok = True
        self._sent_idx = 0
        # stream position of the first frame the current receiver got
        # from this generation (0 unless a reborn receiver was replayed
        # the buffer): the base of the frame count its resume reports
        self._recv_base = 0
        # rows per global partition the receiver already holds since my
        # restore epoch (reborn-sender dedup ledger, set from resume)
        self._skip: dict[int, int] = {}
        # rows skipped since the last commit of a barrier sent with no
        # skip left (that receiver's cut holds them), and those barriers
        self._skipped = False
        self._clean_barriers: set[int] = set()
        self._obs_frames = obs.counter(
            "dnz_exchange_frames_total", dir="send", edge=self.edge
        )
        self._obs_bytes = obs.counter(
            "dnz_exchange_bytes_total", dir="send", edge=self.edge
        )
        self._obs_send_ms = obs.histogram(
            "dnz_exchange_send_ms", edge=self.edge
        )
        self._obs_reconnects = obs.counter(
            "dnz_exchange_reconnects_total", edge=self.edge
        )
        self._obs_replayed = obs.counter(
            "dnz_exchange_replayed_frames_total", edge=self.edge
        )

    def connect(self, deadline_s: float = _CONNECT_TIMEOUT_S) -> None:
        """Dial the peer's server socket (which may not be listening yet
        — workers start concurrently), identify this edge with a hello
        frame, then read the peer's resume frame and resend whatever it
        proves undelivered.  Retries cover startup races only; an
        injected fault or the deadline fails the worker outright."""
        faults.inject("exchange.connect", key=self.edge)
        self._dial_and_resume(deadline_s, reconnect=False)

    def _dial_and_resume(self, deadline_s: float, reconnect: bool) -> None:
        """Dial + hello + read resume, retrying handshake failures
        (peer not listening yet, peer mid-restart, injected
        ``exchange.reconnect`` faults) with bounded exponential backoff
        until ``deadline_s``.  A peer that dies while its replay is
        written is retried too: its next incarnation's resume decides the
        replay anew (the JAX client lets the broken pipe kill its worker).
        Other replay-phase errors are NOT retried — a tagged fallback or a
        torn replay frame propagates."""
        deadline = time.monotonic() + deadline_s
        backoff = _RECONNECT_BACKOFF_S[0]
        last: Exception | None = None
        while time.monotonic() < deadline:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                if reconnect:
                    faults.inject("exchange.reconnect", key=self.edge)
                s.connect(self.sock_path)
                s.settimeout(10.0)
                s.sendall(framing.encode_hello(
                    self.src, self.gen, self.restore_epoch
                ))
                payload = framing.read_frame(s)
                if payload is None:
                    raise SourceError(
                        f"exchange peer on {self.edge} closed before resume"
                    )
                resume = framing.decode_frame(payload, None)
                if resume[0] != "resume":
                    raise SourceError(
                        f"exchange peer on {self.edge} answered hello "
                        f"with {resume[0]!r}"
                    )
                s.settimeout(None)
            except (OSError, socket.timeout, SourceError) as e:
                s.close()
                last = e
                time.sleep(backoff)
                backoff = min(backoff * 2, _RECONNECT_BACKOFF_S[1])
                continue
            self._sock = s
            try:
                self._apply_resume(resume)
            except OSError as e:
                self.close()
                last = e
                time.sleep(backoff)
                backoff = min(backoff * 2, _RECONNECT_BACKOFF_S[1])
                continue
            return
        raise SourceError(
            f"exchange connect {self.edge} failed after {deadline_s}s: {last}"
        )

    def _apply_resume(self, resume: tuple) -> None:
        """Resolve the receiver's resume frame into a replay plan and
        execute it — see the module docstring for the three modes."""
        _, gen_seen, frames_seen, _epoch, counts, counts_ok = resume
        if gen_seen == self.gen:
            # same-generation tear-heal: resend exactly the frames the
            # receiver never fully processed.  Its count starts at the
            # first frame it got from this generation: frame 0, or the
            # head of the buffer replayed to it when it was reborn
            first = self._recv_base + frames_seen
            with self._buf_lock:
                needed = [e for e in self._buf if e[0] >= first]
                replay_ok = self._replay_ok
            if needed and (
                not replay_ok or needed[0][0] != first
            ):
                raise cluster_fallback_error(
                    f"exchange edge {self.edge} cannot tear-heal: replay "
                    f"buffer no longer covers frame {frames_seen}"
                )
            self._replay(needed)
            return
        if gen_seen >= 0:
            # I am a reborn sender talking to a receiver that survived:
            # it reports rows per partition already delivered since my
            # pinned epoch; the router skips exactly that prefix
            if not counts_ok:
                raise cluster_fallback_error(
                    f"exchange edge {self.edge} rejoin: receiver cannot "
                    "attribute delivered rows to partitions"
                )
            self._skip = {int(k): int(v) for k, v in counts.items()}
            return
        # fresh receiver (reborn, or first contact): resend everything
        # since the last cluster-committed barrier — which is exactly
        # what the pruned buffer holds
        with self._buf_lock:
            needed = list(self._buf)
            replay_ok = self._replay_ok
            skipped = self._skipped
        if needed and not replay_ok:
            raise cluster_fallback_error(
                f"exchange edge {self.edge} cannot replay to reborn "
                "receiver: buffer was evicted past the committed barrier"
            )
        if skipped:
            # rows this (reborn) sender skipped because the receiver's
            # previous incarnation held them were never sent, so no buffer
            # holds them for the new one (the JAX package replays without
            # them; a same-epoch double rebirth masks it there, ROADMAP §C)
            raise cluster_fallback_error(
                f"exchange edge {self.edge} cannot replay to reborn "
                "receiver: rows skipped since the last commit were never "
                "sent"
            )
        self._recv_base = needed[0][0] if needed else self._sent_idx
        self._replay(needed)

    def _replay(self, entries: list[tuple]) -> None:
        """Resend buffered frames verbatim on the fresh connection.
        ``cluster.replay`` is torn-capable: a truncated replay frame is
        genuinely written, then this worker fails — the same
        fail-stop-per-worker contract as a torn first send."""
        for _idx, _kind, _epoch, frame in entries:
            payload = faults.inject(
                "cluster.replay", key=self.edge, payload=frame
            )
            self._sock.sendall(payload)
            if len(payload) != len(frame):
                self.close()
                raise SourceError(
                    f"exchange replay frame torn by fault injection on "
                    f"{self.edge} ({len(payload)}/{len(frame)} bytes)"
                )
            self._obs_replayed.add(1)

    def take_skip(self, part: int, n_rows: int) -> int:
        """Rows the router must drop from the front of this partition's
        next batch bound for ``dst`` (reborn-sender dedup)."""
        have = self._skip.get(part, 0)
        if not have:
            return 0
        s = min(have, n_rows)
        self._skip[part] = have - s
        # note_commit clears the flag on the control thread
        with self._buf_lock:
            self._skipped = True
        return s

    def skip_residual(self) -> dict[int, int]:
        """Undrained dedup skip per partition — piggybacked on barrier
        frames so the receiver's per-epoch ledger snapshot accounts for
        the replay position lagging the delivered frontier."""
        return {p: n for p, n in self._skip.items() if n > 0}

    def note_commit(self, epoch: int) -> None:
        """Coordinator announced cluster commit ``epoch``: every
        receiver provably processed this edge's barrier-``epoch`` frame
        (or drained it to EOS), so everything up to that frame can never
        be needed for replay again."""
        with self._buf_lock:
            cut = None
            saw_eos = None
            for i, (_idx, kind, ep, _f) in enumerate(self._buf):
                if kind == "barrier" and ep == epoch:
                    cut = i
                if kind == "eos":
                    saw_eos = i
            if cut is not None:
                if epoch in self._clean_barriers:
                    self._skipped = False
                dropped = self._buf[: cut + 1]
            elif saw_eos is not None:
                # sender hit EOS before this barrier was issued: every
                # acking receiver drained the edge, so only the EOS
                # frame itself must remain reachable for reborn peers
                dropped = self._buf[:saw_eos]
            else:
                return
            self._buf = self._buf[len(dropped):]
            self._buf_bytes -= sum(len(f) for _, _, _, f in dropped)

    def _buffer(self, kind: str, epoch: int | None, frame: bytes) -> None:
        with self._buf_lock:
            self._buf.append((self._sent_idx, kind, epoch, frame))
            self._buf_bytes += len(frame)
            while self._buf_bytes > self._buf_cap and len(self._buf) > 1:
                idx, k, ep, f = self._buf.pop(0)
                self._buf_bytes -= len(f)
                if k != "eos":
                    # evicted un-committed frames: replay is no longer
                    # exact, escalate to full restart if ever needed
                    self._replay_ok = False

    def send(
        self, frame: bytes, kind: str = "data", epoch: int | None = None
    ) -> None:
        """Write one frame (buffering it first when reconnectable).  A
        ``torn`` fault rule truncates the bytes actually written and
        then drops the connection, so the tear is observed where real
        tears are: at the receiver.  A plain connection failure under
        ``partial`` redials with bounded exponential backoff and lets
        the resume handshake resend the tail — the blocked ingest
        thread IS the backpressure against a down edge."""
        if self._sock is None:
            raise SourceError(f"exchange edge {self.edge} not connected")
        if self.partial:
            self._buffer(kind, epoch, frame)
            if kind == "barrier" and not self.skip_residual():
                self._clean_barriers.add(epoch)
        t0 = time.perf_counter()
        payload = faults.inject("exchange.send", key=self.edge, payload=frame)
        try:
            self._sock.sendall(payload)
        except OSError as e:
            if not self.partial:
                raise SourceError(
                    f"exchange send on {self.edge} failed: {e}"
                ) from e
            self._reconnect(e)
        if len(payload) != len(frame):
            # the torn prefix is on the wire; kill the connection so the
            # receiver sees a mid-frame EOF/CRC failure, then fail this
            # worker — exactly what a mid-send process death looks like
            self.close()
            raise SourceError(
                f"exchange frame torn by fault injection on {self.edge} "
                f"({len(payload)}/{len(frame)} bytes written)"
            )
        self._sent_idx += 1
        self._obs_frames.add(1)
        self._obs_bytes.add(len(frame))
        self._obs_send_ms.observe((time.perf_counter() - t0) * 1e3)

    def _reconnect(self, cause: Exception) -> None:
        """Redial a down edge until ``reconnect_deadline_s``; the resume
        handshake replays the buffered tail (including the frame whose
        write just failed — it was buffered before the attempt).  Past
        the deadline the worker escalates to the full-cluster fallback
        rather than stall forever."""
        self.close()
        self._obs_reconnects.add(1)
        try:
            self._dial_and_resume(
                self.reconnect_deadline_s, reconnect=True
            )
        except SourceError as e:
            if getattr(e, "cluster_fallback", False):
                raise
            raise cluster_fallback_error(
                f"exchange edge {self.edge} down past "
                f"{self.reconnect_deadline_s}s reconnect budget "
                f"(send failed: {cause}; last: {e})"
            ) from e

    def redial_after_eos(self) -> None:
        """Peer ``dst`` was reborn after this edge's stream ended (the
        router sent EOS and closed the edge, so no later send fails and
        redials on its own): dial the reborn receiver, let its resume frame
        replay the buffered tail since the last cluster commit — the EOS
        frame included — and close again.  A receiver that already got the
        tail from a send's own redial answers with its frame count, and
        nothing is resent.  The JAX package has no such step, and a
        reborn receiver there waits forever for a finished survivor's
        edge (ROADMAP §C)."""
        self._dial_and_resume(self.reconnect_deadline_s, reconnect=True)
        self.close()

    def close(self) -> None:
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


class EdgeState:
    """Receiver-side state of one inbound edge.

    Beyond the merge state (queue / watermark / alignment / EOS), an
    edge carries the **rejoin ledgers**: the sender generation last
    heard from, how many post-hello frames of that generation were
    fully processed (the implicit sequence number), cumulative rows
    delivered per global source partition, and a snapshot of those
    counts at every barrier — ``counts - barrier_marks[C]`` is exactly
    what a sender reborn at epoch C must skip.  The counts survive
    sender generations (they ledger *deliveries*, not connections)."""

    __slots__ = (
        "edge_id", "queue", "wm", "aligned", "eos", "depth_gauge",
        "gen", "frames_seen", "part_counts", "barrier_marks",
        "counts_ok", "down", "conn", "settled", "eos_received",
    )

    def __init__(self, edge_id: int, depth_gauge) -> None:
        self.edge_id = edge_id
        self.queue: queue.Queue = queue.Queue(maxsize=EDGE_QUEUE_ITEMS)
        self.wm: int | None = None
        self.aligned = False  # delivered the in-flight barrier epoch
        self.eos = False
        self.depth_gauge = depth_gauge
        self.gen = -1  # sender generation last seen (-1 = never)
        self.frames_seen = 0  # frames fully processed from that gen
        self.part_counts: dict[int, int] = {}
        self.barrier_marks: dict[int, dict[int, int]] = {}
        self.counts_ok = True  # False once an unstamped batch arrives
        self.down = False
        self.conn = None
        self.settled = threading.Event()
        self.settled.set()
        # the receive loop read this edge's eos frame (``eos`` is the
        # merger's: set when it consumes the frame)
        self.eos_received = False


class ExchangeServer:
    """This worker's inbound half: accepts N-1 peer connections, runs
    one decode thread per connection, and exposes the per-edge queues to
    the :class:`EdgeMerger`."""

    def __init__(
        self,
        worker_id: int,
        n_workers: int,
        sock_path: str,
        schema,
        partial: bool = False,
        last_commit: int = 0,
    ) -> None:
        from denormalized_tpu_torch import obs

        self.worker_id = worker_id
        self.n_workers = n_workers
        self.schema = schema
        self.sock_path = sock_path
        self.partial = bool(partial)
        self.last_commit = int(last_commit)
        self.edges: dict[int, EdgeState] = {
            w: EdgeState(
                w,
                obs.gauge(
                    "dnz_exchange_edge_depth", edge=f"{w}->{worker_id}"
                ),
            )
            for w in range(n_workers)
        }
        self._obs_frames = obs.counter(
            "dnz_exchange_frames_total", dir="recv",
            edge=f"*->{worker_id}",
        )
        self._obs_bytes = obs.counter(
            "dnz_exchange_bytes_total", dir="recv",
            edge=f"*->{worker_id}",
        )
        self._obs_down = obs.gauge(
            "dnz_exchange_edges_down", worker=str(worker_id)
        )
        # this worker restored at last_commit: on every edge it holds no
        # row delivered after that barrier, so a sender reborn at the same
        # epoch skips nothing it is owed (the JAX package keeps no mark
        # here, and two workers recovering at one epoch fall back to the
        # full restart: "cannot attribute", ROADMAP §C)
        for e in self.edges.values():
            e.barrier_marks[self.last_commit] = {}
        self.wake = threading.Event()
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(sock_path)
        self._listener.listen(n_workers)
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"exch-accept-{worker_id}",
            daemon=True,
        )
        self._accept_thread.start()

    def note_commit(self, epoch: int) -> None:
        """Coordinator announced cluster commit ``epoch``: barrier
        snapshots older than it can never anchor a rejoin again."""
        self.last_commit = max(self.last_commit, int(epoch))
        for e in self.edges.values():
            for k in [k for k in e.barrier_marks if k < epoch]:
                del e.barrier_marks[k]

    def _set_down_gauge(self) -> None:
        self._obs_down.set(
            sum(1 for e in self.edges.values() if e.down)
        )

    # -- loopback (ingest half of THIS worker) ---------------------------
    def local_put(self, item: tuple) -> None:
        """Zero-copy enqueue from this worker's own ingest half — no
        socket, no framing, no fault site (the in-process edge is not an
        I/O boundary)."""
        edge = self.edges[self.worker_id]
        edge.queue.put(item)
        edge.depth_gauge.set(edge.queue.qsize())
        self.wake.set()

    # -- socket side ------------------------------------------------------
    def _accept_loop(self) -> None:
        """Accept until stopped — NOT just n_workers-1 connections: a
        reconnecting or reborn sender dials the same listener, and its
        hello re-binds the existing edge (ledgers intact)."""
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed during shutdown
            t = threading.Thread(
                target=self._recv_loop, args=(conn,),
                name=f"exch-recv-{self.worker_id}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _bind_conn(self, conn: socket.socket, wid: int, gen: int,
                   restore: int) -> EdgeState:
        """Re-bind an edge to a fresh connection and answer the hello
        with a resume frame.  If an older connection is still attached
        (the sender redialed before our read observed the break), close
        it and wait for its loop to settle FIRST — two loops feeding
        one queue would interleave frames and corrupt the ledgers."""
        edge = self.edges[wid]
        old = edge.conn
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
            edge.settled.wait(timeout=10.0)
        if gen != edge.gen and edge.gen >= 0:
            # reborn sender: report rows already delivered per
            # partition since its pinned epoch so it skips exactly
            # that prefix on replay
            base = {} if restore == 0 else edge.barrier_marks.get(restore)
            if base is None or not edge.counts_ok:
                counts, counts_ok = {}, False
            else:
                counts = {
                    p: edge.part_counts.get(p, 0) - base.get(p, 0)
                    for p in set(edge.part_counts) | set(base)
                }
                counts_ok = True
        else:
            counts, counts_ok = {}, True
        conn.sendall(framing.encode_resume(
            edge.gen, edge.frames_seen, self.last_commit, counts, counts_ok
        ))
        if gen != edge.gen:
            edge.gen = gen
            edge.frames_seen = 0
        edge.conn = conn
        edge.settled.clear()
        if edge.down:
            edge.down = False
            self._set_down_gauge()
        return edge

    def _recv_loop(self, conn: socket.socket) -> None:
        """Decode frames from one peer into its edge queue, maintaining
        the rejoin ledgers.  On an integrity/connectivity failure:
        under ``partial`` the edge is marked *down* and the loop exits
        — the merger keeps consuming the other edges and the queued
        prefix of this one until the sender redials; in fail-stop mode
        the failure is delivered IN-BAND as an ("err", exc) item and
        the merger re-raises on the consumer thread."""
        edge: EdgeState | None = None
        try:
            payload = framing.read_frame(conn)
            if payload is None:
                return  # peer connected and vanished before hello
            kind = framing.decode_frame(payload, self.schema)
            if kind[0] != "hello":
                raise SourceError(
                    f"exchange peer spoke {kind[0]!r} before hello"
                )
            edge = self._bind_conn(conn, kind[1], kind[2], kind[3])
            while not self._stop.is_set():
                faults.inject(
                    "exchange.recv",
                    key=f"{edge.edge_id}->{self.worker_id}",
                )
                payload = framing.read_frame(conn)
                if payload is None and edge.eos_received:
                    return  # a redial after this edge's EOS: nothing owed
                if payload is None:
                    # clean EOF without an eos frame: the peer died —
                    # surface, never silently treat as end-of-partition
                    raise SourceError(
                        f"exchange edge {edge.edge_id}->{self.worker_id} "
                        "closed without EOS"
                    )
                if edge.conn is not conn:
                    return  # replaced by a newer connection
                item = framing.decode_frame(payload, self.schema)
                self._obs_frames.add(1)
                self._obs_bytes.add(len(payload))
                t = item[0]
                if t == "data":
                    _, batch, wm, part = item
                    if part is None:
                        edge.counts_ok = False
                    else:
                        edge.part_counts[part] = (
                            edge.part_counts.get(part, 0) + batch.num_rows
                        )
                    item = ("data", batch, wm)
                elif t == "barrier":
                    _, ep, skips = item
                    marks = dict(edge.part_counts)
                    for p, n in skips.items():
                        # the sender was mid-replay: n of this
                        # partition's delivered rows actually sit AT OR
                        # AFTER the barrier's stream position, so they
                        # don't belong in the epoch's baseline
                        marks[p] = marks.get(p, 0) - n
                    edge.barrier_marks[ep] = marks
                    item = ("barrier", ep)
                edge.frames_seen += 1
                if not edge.eos:
                    edge.queue.put(item)
                    edge.depth_gauge.set(edge.queue.qsize())
                    self.wake.set()
                # else: the edge already drained to EOS — a reborn
                # sender re-walking its stream can only produce frames
                # the skip ledger emptied (wm/barrier/eos), all of
                # which an EOS edge satisfies implicitly
                if t == "eos":
                    edge.eos_received = True
                    return
        except (SourceError, OSError) as e:
            if edge is not None:
                if self.partial:
                    edge.down = True
                    self._set_down_gauge()
                else:
                    edge.queue.put(("err", e))
                    self.wake.set()
            # hello never arrived: no edge to mark — the merger will
            # starve and the coordinator's liveness timeout recovers
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if edge is not None and edge.conn is conn:
                edge.conn = None
                edge.settled.set()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


class EdgeMerger:
    """Single consumer over all inbound edges: data interleaves freely,
    watermarks merge as the min over live edges, barriers align, EOS
    collapses when unanimous.  Yields engine stream items — see
    :class:`~denormalized_tpu_torch.cluster.runtime.ExchangeSourceExec` for
    where they enter the keyed pipeline."""

    def __init__(self, server: ExchangeServer) -> None:
        self.server = server
        self._merged_wm: int | None = None
        #: epochs ≤ this were aborted by the coordinator (a worker died
        #: with the barrier in flight) or already committed before this
        #: worker was (re)born — their markers must neither align nor
        #: overlap-check, whether they arrive late or via replay
        self.abort_floor = 0

    def abort_to(self, epoch: int) -> None:
        """Coordinator aborted the in-flight barrier ``epoch`` (it will
        never commit; the next barrier uses a FRESH number — epoch
        reuse is unsound because a peer may already hold a snapshot cut
        at the aborted number).  Any partial alignment unwinds: edges
        that already delivered the aborted marker resume consumption,
        and their post-marker rows simply belong to the next epoch's
        window."""
        self.abort_floor = max(self.abort_floor, int(epoch))
        self.server.wake.set()

    def _merged_watermark(self) -> int | None:
        """Min over non-EOS edges; an exhausted edge leaves the min
        (same rule as finished partitions in _PartitionWatermarks)."""
        live = [
            e.wm for e in self.server.edges.values() if not e.eos
        ]
        if not live or any(w is None for w in live):
            return None
        return min(live)

    def __iter__(self):
        """→ ("data", batch) | ("wm", ts) | ("barrier", epoch) | EOS (by
        StopIteration).  Runs on the keyed half's thread."""
        edges = list(self.server.edges.values())
        barrier_epoch: int | None = None
        while True:
            if barrier_epoch is not None and barrier_epoch <= self.abort_floor:
                # the in-flight barrier was aborted mid-alignment:
                # unwind the cut, resume consuming the aligned edges
                for x in edges:
                    x.aligned = False
                barrier_epoch = None
            progressed = False
            for e in edges:
                if e.eos or e.aligned:
                    continue
                try:
                    item = e.queue.get_nowait()
                except queue.Empty:
                    continue
                e.depth_gauge.set(e.queue.qsize())
                progressed = True
                t = item[0]
                if t == "err":
                    raise item[1]
                if t == "data":
                    _, batch, wm = item
                    if wm is not None and (e.wm is None or wm > e.wm):
                        e.wm = wm
                    yield ("data", batch)
                    merged = self._merged_watermark()
                    if merged is not None and (
                        self._merged_wm is None or merged > self._merged_wm
                    ):
                        self._merged_wm = merged
                        yield ("wm", merged)
                elif t == "wm":
                    if e.wm is None or item[1] > e.wm:
                        e.wm = item[1]
                    merged = self._merged_watermark()
                    if merged is not None and (
                        self._merged_wm is None or merged > self._merged_wm
                    ):
                        self._merged_wm = merged
                        yield ("wm", merged)
                elif t == "barrier":
                    if item[1] <= self.abort_floor:
                        continue  # aborted or stale-replayed marker
                    if barrier_epoch is not None and item[1] != barrier_epoch:
                        raise SourceError(
                            f"exchange barrier overlap: epoch {item[1]} "
                            f"arrived while {barrier_epoch} is aligning "
                            "(the coordinator issues barriers serially)"
                        )
                    barrier_epoch = item[1]
                    e.aligned = True
                elif t == "eos":
                    e.eos = True
                else:
                    raise SourceError(f"unknown exchange item {t!r}")
                # an EOS edge satisfies any in-flight barrier (its
                # sender persisted final offsets coordinator-side)
                if barrier_epoch is not None and all(
                    x.aligned or x.eos for x in edges
                ):
                    for x in edges:
                        x.aligned = False
                    ep, barrier_epoch = barrier_epoch, None
                    yield ("barrier", ep)
                if all(x.eos for x in edges):
                    return
            if not progressed:
                self.server.wake.wait(timeout=0.002)
                self.server.wake.clear()
