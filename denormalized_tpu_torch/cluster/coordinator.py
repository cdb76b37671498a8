"""Cluster coordinator: spawn workers, align barriers, commit epochs,
supervise, rescale on restore.

Counterpart of ``denormalized_tpu/cluster/coordinator.py``.  One
difference: the JAX coordinator defaults its workers to the host
(``JAX_PLATFORMS=cpu``); here a worker runs on the device its job's
``engine`` overrides name, ``EngineConfig``'s ``cuda`` by default, so
several workers share one card.  The run summary also carries each
worker's ``eos`` report (its device and kernel launch counters) and its
start-up seconds (spawn to ready).

The coordinator is a small control plane — it never touches row data.
Its one durable artifact is ``meta/commits.jsonl``: an epoch appears
there only after EVERY worker acked it (offsets + keyed snapshots
durable in each worker's own store), which makes the last line the
cluster-consistent recovery point.  Worker-local commit records are
proposals; restore pins every worker to the cluster-committed epoch
(cluster/worker.py PinnedCheckpointCoordinator).

Supervision is a two-tier restart state machine
(docs/cluster.md#failure-matrix):

- **Partial recovery** (the default when checkpointing is on and at
  least one epoch cluster-committed): a single dead worker — SIGKILL,
  nonzero exit, error report, or a per-worker liveness stall while its
  peers keep streaming — is respawned ALONE, pinned to the last
  cluster-committed epoch with a bumped per-worker generation, while
  survivors never stop: their exchange senders buffer-or-reconnect and
  the rejoin handshake (cluster/exchange.py) dedupes the replay
  exactly.  Any barrier in flight at death time is ABORTED (its epoch
  number is never reused within the incarnation) because the respawn
  restores strictly below it.
- **Full-cluster restart** — the documented fallback: partial recovery
  ineligible (no commits yet / checkpointing off / ``partial_recovery``
  false), a worker-reported error tagged ``fallback: "cluster"``
  (replay-buffer gap, unstamped ledgers), a rejoin over
  ``rejoin_timeout_s``, or an exhausted per-worker budget.

Both tiers spend RATE-based budgets, the prefetch supervisor's
streak+refund pattern one level up: every restart opens a streak and a
crash-free ``restart_heal_s`` interval refunds it, so a days-long
stream with occasional healed deaths never converges to a guaranteed
kill while a crash-storm exhausts its budget promptly.  Exactly-once
OUTPUT across restarts of either tier is the reader-side clip protocol
(cluster/reader.py), applied per worker slot.

On restore with a DIFFERENT ``n_workers`` the coordinator first runs
cluster/rescale.py, which re-buckets every worker's checkpointed keyed
and spilled state plus source offsets under the new hash map into a new
store version, then starts the new workers pinned at the same epoch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.cluster.hashing import partitions_for
from denormalized_tpu_torch.cluster.spec import ClusterSpec

#: grace between observing a worker process death and acting on it:
#: a worker that dies AFTER reporting an error (possibly tagged
#: ``fallback: "cluster"``) must be attributed by its report, not by
#: its exit code — the report decides partial vs full recovery
_DEATH_GRACE_S = 0.5


def _fsync_append(path: str, line: str) -> None:
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


class _RestartBudget:
    """Shared token pool (the prefetch supervisor's budget, one level
    up): ``take`` spends one token, ``refund`` returns healed streaks,
    capped at the initial allowance."""

    def __init__(self, cap: int) -> None:
        self._cap = max(0, int(cap))
        self._n = self._cap
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self._n <= 0:
                return False
            self._n -= 1
            return True

    def refund(self, n: int = 1) -> None:
        with self._lock:
            self._n = min(self._cap, self._n + n)

    def remaining(self) -> int:
        with self._lock:
            return self._n


class _WorkerStreak:
    """One worker's restart streak against the cluster-global pool.

    ``take()`` first heals: a crash-free ``heal_s`` interval since the
    last restart refunds the whole streak to the pool.  Then it admits
    the restart only if the streak stays under the per-worker cap AND
    the pool still has a token — so one crash-looping worker cannot
    starve its peers' budgets, and spaced healed deaths never
    accumulate."""

    def __init__(self, cap: int, heal_s: float, pool: _RestartBudget) -> None:
        self.cap = int(cap)
        self.heal_s = float(heal_s)
        self.pool = pool
        self.streak = 0
        self.last = 0.0

    def take(self) -> bool:
        now = time.monotonic()
        if self.streak and now - self.last >= self.heal_s:
            self.pool.refund(self.streak)
            self.streak = 0
        if self.streak >= self.cap or not self.pool.take():
            return False
        self.streak += 1
        self.last = now
        return True


class _WorkerConn:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.wlock = threading.Lock()

    def send(self, obj: dict) -> bool:
        try:
            with self.wlock:
                self.sock.sendall((json.dumps(obj) + "\n").encode())
            return True
        except OSError:
            return False


class Coordinator:
    def __init__(
        self,
        spec: ClusterSpec,
        *,
        kill_after_commits: int | None = None,
        kill_worker_after_s: float | None = None,
        kill_worker_id: int = 0,
        kill_plan: list | None = None,
    ) -> None:
        self.spec = spec
        self.kill_after_commits = kill_after_commits
        self.kill_worker_after_s = kill_worker_after_s
        self.kill_worker_id = kill_worker_id
        #: scripted chaos for recovery interleavings (tests): ordered
        #: entries fired one at a time — ``{"worker": w}`` plus either
        #: ``"after_s"`` (seconds into the incarnation),
        #: ``"after_ready_s"`` (seconds since the last worker reported
        #: ready, no worker mid-rejoin) or ``"when"``:
        #: "inflight" (a barrier is aligning), "recovering" (some
        #: worker — optionally ``"of"`` — is mid-rejoin), or
        #: "recovered" with ``"of"`` (that worker finished a rejoin);
        #: optional ``"delay_s"`` after the condition first holds and
        #: ``"min_commits"`` (hold fire until the committed epoch
        #: reaches this — partial recovery needs a cut to exist)
        self.kill_plan = [dict(e) for e in (kill_plan or [])]
        self._kp_idx = 0
        self.workdir = spec.workdir
        for d in ("sock", "out", "obs", "meta", "state"):
            os.makedirs(os.path.join(self.workdir, d), exist_ok=True)
        self._spec_path = os.path.join(self.workdir, "meta", "spec.json")
        with open(self._spec_path, "w") as f:
            f.write(spec.to_json())
        self._manifest_path = os.path.join(
            self.workdir, "meta", "manifest.json"
        )
        self._commits_path = os.path.join(
            self.workdir, "meta", "commits.jsonl"
        )
        self._segments_path = os.path.join(
            self.workdir, "meta", "segments.jsonl"
        )
        self._cluster_state_path = os.path.join(
            self.workdir, "meta", "cluster_state.json"
        )
        self._procs: dict[int, subprocess.Popen] = {}
        self._conns: dict[int, _WorkerConn] = {}
        self._events: queue.Queue = queue.Queue()
        self._listener: socket.socket | None = None
        self.restarts = 0  # lifetime FULL-cluster restarts (reporting)
        self.worker_restarts = 0  # lifetime single-worker respawns
        self.recoveries: list[dict] = []  # {"worker", "ms"} per rejoin
        self.aborted_epochs: list[int] = []
        self.crash_log: list[str] = []  # why each (re)start happened
        #: every SIGKILL this coordinator sent (kill plan, timed kill):
        #: worker, incarnation, the committed epoch before it and its
        #: seconds after the last worker's ready
        self.kills: list[dict] = []
        #: spawn → "ready" seconds of every spawn, full or partial
        self.startups: list[dict] = []
        #: generation token: bumped before each spawn; control events
        #: are tagged with the token current when their connection was
        #: accepted, so a killed generation's buffered acks/eos can
        #: never be attributed to the respawned workers (epoch numbers
        #: REPEAT across incarnations — a stale ack for epoch E would
        #: otherwise cluster-commit E without the new workers' state)
        self._gen_token = 0
        #: per-worker incarnation numbers within the current cluster
        #: generation: 0 at every full spawn, bumped per partial
        #: respawn — the second tag on control events (a respawned
        #: worker's peers still hold the SAME cluster token)
        self._wgen: dict[int, int] = {
            i: 0 for i in range(spec.n_workers)
        }
        # rate budgets (see module docstring): partial pool is shared
        # cluster-wide; the per-worker streak caps any one worker
        self._partial_pool = _RestartBudget(
            max(1, spec.worker_max_restarts) * spec.n_workers
        )
        self._wstreaks: dict[int, _WorkerStreak] = {
            i: _WorkerStreak(
                spec.worker_max_restarts, spec.restart_heal_s,
                self._partial_pool,
            )
            for i in range(spec.n_workers)
        }
        self._full_streak = 0
        self._full_last = 0.0
        self.out_files: dict[int, list[str]] = {
            i: [] for i in range(spec.n_workers)
        }
        #: worker start-up: spawn → "ready" seconds of each worker's
        #: latest incarnation (process start, imports, device context,
        #: plan, restore, exchange listener)
        self._spawned_at: dict[int, float] = {}
        self.startup_s: dict[int, float] = {}
        from denormalized_tpu_torch import obs

        self._obs_recovery = obs.histogram("dnz_cluster_recovery_ms")
        self._obs_wrestarts: dict[int, object] = {}

    def _obs_wrestart(self, wid: int):
        c = self._obs_wrestarts.get(wid)
        if c is None:
            from denormalized_tpu_torch import obs

            c = obs.counter(
                "dnz_cluster_worker_restarts_total", worker=str(wid)
            )
            self._obs_wrestarts[wid] = c
        return c

    # -- durable meta -----------------------------------------------------
    def read_manifest(self) -> dict | None:
        try:
            with open(self._manifest_path) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    def committed_epochs(self) -> list[dict]:
        out = []
        try:
            f = open(self._commits_path)
        except FileNotFoundError:
            return out
        with f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn tail from a killed coordinator
        return out

    def last_committed(self) -> int | None:
        commits = self.committed_epochs()
        return commits[-1]["epoch"] if commits else None

    def segments(self) -> list[dict]:
        """Durable incarnation history: one record per spawn — full
        records carry one file per worker slot, partial records carry
        ``"worker"`` and that worker's single file — each naming its
        restore epoch: what the exactly-once reader (cluster/reader.py)
        clips across, per slot.  Survives coordinator restarts AND
        worker-count changes (output slots re-map under rescale; epochs
        are cluster-global)."""
        out = []
        try:
            f = open(self._segments_path)
        except FileNotFoundError:
            return out
        with f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out

    def store_dir(self, version: int, worker: int) -> str:
        return os.path.join(
            self.workdir, "state", f"v{version}", f"worker_{worker}"
        )

    # -- lifecycle --------------------------------------------------------
    def _checkpointing(self) -> bool:
        return self.spec.checkpoint_interval_s is not None

    def _start_control_server(self) -> None:
        from denormalized_tpu_torch.cluster.worker import ctrl_sock_path

        path = ctrl_sock_path(self.workdir)
        if os.path.exists(path):
            os.unlink(path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(self.spec.n_workers * 2)
        threading.Thread(
            target=self._accept_loop, name="cluster-accept", daemon=True
        ).start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._conn_loop, args=(conn, self._gen_token),
                name="cluster-conn", daemon=True,
            ).start()

    def _conn_loop(self, conn: socket.socket, token: int) -> None:
        f = conn.makefile("r", encoding="utf-8")
        wid = None
        wtok = 0
        try:
            hello = json.loads(f.readline())
            if hello.get("ev") != "hello":
                conn.close()
                return
            wid = int(hello["worker"])
            # second staleness tag: this worker's incarnation number at
            # connect time — a partially-respawned worker bumps it, so
            # its dead predecessor's buffered events can't leak in
            wtok = self._wgen.get(wid, 0)
            self._conns[wid] = _WorkerConn(conn)
            self._events.put(("hello", wid, hello, token, wtok))
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                self._events.put(("msg", wid, msg, token, wtok))
        except (OSError, ValueError):
            pass
        finally:
            if wid is not None:
                self._events.put(("conn_lost", wid, {}, token, wtok))
            try:
                conn.close()
            except OSError:
                pass

    def _spec_path_for(self, gen: int) -> str:
        """Spec file for spawn generation ``gen``: respawned
        incarnations run fault-free under ``fault_plan_once`` (see
        ClusterSpec) — partial respawns count, their generation index
        is global."""
        if gen > 0 and self.spec.fault_plan and self.spec.fault_plan_once:
            path = os.path.join(
                self.workdir, "meta", "spec_nofault.json"
            )
            if not os.path.exists(path):
                clean = dataclasses.replace(self.spec, fault_plan=None)
                with open(path, "w") as f:
                    f.write(clean.to_json())
            return path
        return self._spec_path

    def _worker_argv(
        self, spec_path: str, wid: int, store: str,
        restore_epoch: str, seq: int, out: str, abort_floor: int = 0,
    ) -> list[str]:
        return [
            sys.executable, "-m", "denormalized_tpu_torch.cluster.worker",
            "--spec", spec_path,
            "--worker", str(wid),
            "--store", store,
            "--restore-epoch", restore_epoch,
            "--seq", str(seq),
            "--out", out,
            "--gen", str(self._wgen.get(wid, 0)),
            "--abort-floor", str(abort_floor),
        ]

    def _popen_worker(self, argv: list[str], wid: int) -> subprocess.Popen:
        # the worker's device is its job's EngineConfig (default "cuda"):
        # nothing here hides the card or picks the CPU for it
        self._spawned_at[wid] = time.perf_counter()
        return subprocess.Popen(
            argv,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            )),
        )

    def _spawn_workers(
        self, seq: int, store_version: int, restore_epoch: str
    ) -> None:
        # stale exchange sockets from a killed incarnation must not
        # accept this incarnation's connects
        sockdir = os.path.join(self.workdir, "sock")
        for name in os.listdir(sockdir):
            if name.startswith("exch_"):
                os.unlink(os.path.join(sockdir, name))
        # a full spawn resets every worker's incarnation number — the
        # cluster token (bumped by the caller) already fences the old
        # generation's events
        self._wgen = {i: 0 for i in range(self.spec.n_workers)}
        # global generation number: unique across coordinator restarts
        # (a resumed coordinator must never append into a previous
        # incarnation's files, and the reader needs total order)
        gen = len(self.segments())
        spec_path = self._spec_path_for(gen)
        outs = []
        for i in range(self.spec.n_workers):
            os.makedirs(
                self.store_dir(store_version, i), exist_ok=True
            )
            outs.append(os.path.join(
                self.workdir, "out", f"g{gen:04d}_w{i}.jsonl"
            ))
        _fsync_append(self._segments_path, json.dumps({
            "gen": gen,
            "n_workers": self.spec.n_workers,
            "restored": (
                None if restore_epoch in ("off", "none")
                else int(restore_epoch)
            ),
            "files": outs,
        }))
        for i in range(self.spec.n_workers):
            store = self.store_dir(store_version, i)
            out = outs[i]
            self.out_files[i].append(out)
            self._procs[i] = self._popen_worker(self._worker_argv(
                spec_path, i, store, restore_epoch, seq, out
            ), i)

    def _spawn_one(
        self, wid: int, seq: int, store_version: int,
        committed: int, abort_floor: int,
    ) -> None:
        """Respawn ONE worker pinned to the last cluster-committed
        epoch (partial recovery); its peers keep running.  Appends a
        partial segment record so the reader clips exactly this slot's
        replayed suffix."""
        gen = len(self.segments())
        out = os.path.join(
            self.workdir, "out", f"g{gen:04d}_w{wid}.jsonl"
        )
        self.out_files[wid].append(out)
        _fsync_append(self._segments_path, json.dumps({
            "gen": gen,
            "n_workers": self.spec.n_workers,
            "worker": wid,
            "restored": committed,
            "files": [out],
            "partial": True,
        }))
        store = self.store_dir(store_version, wid)
        os.makedirs(store, exist_ok=True)
        self._procs[wid] = self._popen_worker(self._worker_argv(
            self._spec_path_for(gen), wid, store, str(committed),
            seq, out, abort_floor=abort_floor,
        ), wid)

    def _kill_all(self) -> None:
        for p in self._procs.values():
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self._procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self._procs.clear()
        self._conns.clear()

    def _broadcast(self, obj: dict) -> None:
        for wc in list(self._conns.values()):
            wc.send(obj)

    # -- main loop --------------------------------------------------------
    def run(self) -> dict:
        """Run the cluster to completion (or to the configured kill),
        supervising restarts.  Returns the run summary."""
        t_start = time.perf_counter()
        self._start_control_server()
        try:
            return self._run_supervised(t_start)
        finally:
            self._kill_all()
            if self._listener is not None:
                try:
                    self._listener.close()
                except OSError:
                    pass

    def _prepare_incarnation(self) -> tuple[int, str]:
        """→ (store_version, restore_epoch_arg), rescaling if the
        manifest's worker count differs from the spec's."""
        if not self._checkpointing():
            return 0, "off"
        manifest = self.read_manifest()
        committed = self.last_committed()
        if manifest is None or committed is None:
            return (manifest or {}).get("store_version", 0), "none"
        if manifest["n_workers"] != self.spec.n_workers:
            from denormalized_tpu_torch.cluster.rescale import rescale_cluster

            new_version = manifest["store_version"] + 1
            rescale_cluster(
                self, manifest, committed, self.spec.n_workers, new_version
            )
            manifest["n_workers"] = self.spec.n_workers
            manifest["store_version"] = new_version
            self._write_manifest(manifest)
        return self.read_manifest()["store_version"], str(committed)

    def _run_supervised(self, t_start: float) -> dict:
        seq = 0
        killed_workers = 0
        while True:
            store_version, restore_epoch = self._prepare_incarnation()
            status, detail = self._run_incarnation(
                seq, store_version, restore_epoch,
                already_killed=killed_workers,
            )
            seq += 1
            if status == "done":
                commits = self.committed_epochs()
                rows = detail.get("rows", {})
                meta = detail.get("meta", {})
                return {
                    "status": "done",
                    "rows_total": sum(rows.values()),
                    "rows_per_worker": rows,
                    "rows_in_total": sum(
                        int(m.get("rows_in", 0)) for m in meta.values()
                    ),
                    "ingest_wall_s_max": max(
                        [float(m.get("ingest_wall_s", 0.0))
                         for m in meta.values()] or [0.0]
                    ),
                    "worker_wall_s_max": max(
                        [float(m.get("worker_wall_s", 0.0))
                         for m in meta.values()] or [0.0]
                    ),
                    "commits": [c["epoch"] for c in commits],
                    # each worker's eos report (rows, walls, device and
                    # kernel launch counters) and start-up seconds
                    "workers": {str(k): v for k, v in meta.items()},
                    "startup_s": {
                        str(k): v for k, v in self.startup_s.items()
                    },
                    "restarts": self.restarts,
                    "worker_restarts": self.worker_restarts,
                    "recoveries": list(self.recoveries),
                    "aborted_epochs": list(self.aborted_epochs),
                    "killed_workers": detail.get("killed_workers", 0),
                    "kills": list(self.kills),
                    "startups": list(self.startups),
                    "out_files": {
                        str(k): v for k, v in self.out_files.items()
                    },
                    "segments": self.segments(),
                    "crashes": list(self.crash_log),
                    "wall_s": round(time.perf_counter() - t_start, 3),
                }
            if status == "killed":
                return {
                    "status": "killed",
                    "commits": [
                        c["epoch"] for c in self.committed_epochs()
                    ],
                    "restarts": self.restarts,
                    "worker_restarts": self.worker_restarts,
                    "out_files": {
                        str(k): v for k, v in self.out_files.items()
                    },
                    "segments": self.segments(),
                    "wall_s": round(time.perf_counter() - t_start, 3),
                }
            # crash / wedge: full-cluster restart from the last commit.
            # The budget bounds the failure RATE: a crash-free
            # restart_heal_s interval resets the streak, a storm
            # exhausts it (lifetime ``restarts`` is reporting only).
            self.crash_log.append(str(detail.get("why")))
            killed_workers += detail.get("killed_workers", 0)
            self.restarts += 1
            now = time.monotonic()
            if (
                self._full_streak
                and now - self._full_last >= self.spec.restart_heal_s
            ):
                self._full_streak = 0
            self._full_streak += 1
            self._full_last = now
            if self._full_streak > self.spec.max_restarts:
                raise StateError(
                    f"cluster exceeded restart budget "
                    f"({self.spec.max_restarts}): {detail.get('why')}"
                )

    def _run_incarnation(
        self, seq: int, store_version: int, restore_epoch: str,
        already_killed: int = 0,
    ) -> tuple[str, dict]:
        spec = self.spec
        n = spec.n_workers
        # new generation: bump the token FIRST (conn threads capture it
        # at accept) and drop anything a killed generation left queued
        self._gen_token += 1
        while True:
            try:
                self._events.get_nowait()
            except queue.Empty:
                break
        self._spawn_workers(seq, store_version, restore_epoch)
        ready: dict[int, dict] = {}
        eos_rows: dict[int, int] = {}
        eos_meta: dict[int, dict] = {}
        acked: set[int] = set()
        last_ack: dict[int, int] = {}
        inflight_epoch: int | None = None
        next_barrier_at: float | None = None
        committed = self.last_committed() or 0
        # epochs aborted THIS incarnation: a dead worker's in-flight
        # barrier is abandoned (its respawn restores strictly below
        # it), and its number is never reused while any peer might
        # hold a snapshot cut at it — the next barrier skips past
        aborted: list[int] = []
        recovering: dict[int, dict] = {}  # wid -> {"deadline", "t0"}
        recovered: set[int] = set()  # finished a rejoin this incarnation
        pending_death: dict[int, tuple[float, str]] = {}
        kill_at = (
            time.monotonic() + self.kill_worker_after_s
            if self.kill_worker_after_s is not None and already_killed == 0
            else None
        )
        kp_armed: float | None = None
        killed_workers = 0
        # when the last worker (re)joined: every worker ready, none mid-rejoin
        all_ready_at: float | None = None
        inc_t0 = time.monotonic()
        last_liveness = time.monotonic()
        last_seen: dict[int, float] = {
            i: time.monotonic() for i in range(n)
        }
        partial_ok = (
            bool(spec.partial_recovery) and self._checkpointing()
        )

        def sigkill(wid: int) -> None:
            # wait for the death to take, so the next poll sees it and
            # no barrier is issued to a worker already gone
            p = self._procs[wid]
            self.kills.append({
                "worker": wid, "seq": seq, "gen": self._wgen.get(wid, 0),
                "committed": committed or None,
                "after_ready_s": (
                    round(time.monotonic() - all_ready_at, 3)
                    if all_ready_at is not None else None
                ),
            })
            os.kill(p.pid, signal.SIGKILL)
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

        def fail(why: str) -> tuple[str, dict]:
            self._kill_all()
            return "crashed", {
                "why": why, "killed_workers": killed_workers,
            }

        def write_state() -> None:
            # best-effort doctor snapshot (obs/doctor/clusterdoc.py);
            # atomic replace so readers never see a torn file
            workers = {}
            for w in range(n):
                workers[str(w)] = {
                    "gen": self._wgen.get(w, 0),
                    "last_ack_epoch": last_ack.get(w),
                    "state": (
                        "recovering" if w in recovering
                        else "eos" if w in eos_rows else "up"
                    ),
                }
            payload = {
                "t": round(time.time(), 3),
                "n_workers": n,
                "committed_epoch": committed,
                "inflight_epoch": inflight_epoch,
                "aborted_epochs": list(self.aborted_epochs),
                "worker_restarts": self.worker_restarts,
                "worker_max_restarts": spec.worker_max_restarts,
                "rejoin_timeout_s": spec.rejoin_timeout_s,
                "workers": workers,
            }
            tmp = self._cluster_state_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=2)
                os.replace(tmp, self._cluster_state_path)
            except OSError:
                pass

        def begin_partial(wid: int, why: str):
            """Start single-worker recovery of ``wid``; returns None on
            success or the ``fail(...)`` tuple when ineligible (the
            documented full-cluster fallback)."""
            nonlocal inflight_epoch, acked
            pending_death.pop(wid, None)
            if not (partial_ok and self.last_committed() is not None):
                return fail(why)
            if not self._wstreaks[wid].take():
                return fail(
                    f"{why} [worker {wid} partial-restart budget "
                    "exhausted]"
                )
            self.crash_log.append(f"partial w{wid}: {why}")
            if inflight_epoch is not None:
                # abort the aligning barrier even if ``wid`` already
                # acked it: the respawn pins to committed < inflight,
                # so letting it commit would strand the new worker
                # below the cluster cut
                aborted.append(inflight_epoch)
                self.aborted_epochs.append(inflight_epoch)
                self._broadcast(
                    {"cmd": "abort", "epoch": inflight_epoch}
                )
                inflight_epoch = None
                acked = set()
            self._conns.pop(wid, None)
            p = self._procs.get(wid)
            if p is not None and p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            # only THIS worker's exchange socket: survivors' listeners
            # stay up, their senders hold buffered frames for the edge
            try:
                os.unlink(os.path.join(
                    self.workdir, "sock", f"exch_{wid}.sock"
                ))
            except FileNotFoundError:
                pass
            self._wgen[wid] += 1
            committed_now = self.last_committed() or 0
            self._spawn_one(
                wid, seq, store_version, committed_now,
                abort_floor=max([committed_now] + aborted),
            )
            recovering[wid] = {
                "deadline": time.monotonic() + spec.rejoin_timeout_s,
                "t0": time.perf_counter(),
            }
            ready.pop(wid, None)
            eos_rows.pop(wid, None)
            eos_meta.pop(wid, None)
            acked.discard(wid)
            last_seen[wid] = time.monotonic()
            self.worker_restarts += 1
            self._obs_wrestart(wid).add(1)
            write_state()
            return None

        while True:
            now = time.monotonic()
            # worker process death? Defer action for a grace interval:
            # an error event the dying worker already sent (possibly
            # ``fallback: "cluster"``) must win the attribution
            for wid, p in list(self._procs.items()):
                rc = p.poll()
                if rc is None or wid in pending_death:
                    continue
                if rc != 0:
                    pending_death[wid] = (
                        now + _DEATH_GRACE_S,
                        f"worker {wid} exited rc={rc}",
                    )
                elif wid not in eos_rows:
                    pending_death[wid] = (
                        now + _DEATH_GRACE_S,
                        f"worker {wid} exited before EOS",
                    )
            for wid, (due, why) in list(pending_death.items()):
                if now >= due:
                    r = begin_partial(wid, why)
                    if r is not None:
                        return r
            if kill_at is not None and now >= kill_at:
                # chaos: SIGKILL one worker mid-stream
                p = self._procs.get(self.kill_worker_id)
                if p is not None and p.poll() is None:
                    sigkill(self.kill_worker_id)
                    killed_workers += 1
                kill_at = None
                continue
            if self._kp_idx < len(self.kill_plan):
                ent = self.kill_plan[self._kp_idx]
                when = ent.get("when")
                if committed < int(ent.get("min_commits", 0)):
                    cond = False  # wait until the cut exists
                elif "after_s" in ent:
                    cond = now - inc_t0 >= float(ent["after_s"])
                elif "after_ready_s" in ent:
                    cond = (
                        all_ready_at is not None and not recovering
                        and now - all_ready_at >= float(ent["after_ready_s"])
                    )
                elif when == "inflight":
                    cond = inflight_epoch is not None
                elif when == "recovering":
                    cond = bool(recovering) and (
                        "of" not in ent or ent["of"] in recovering
                    )
                elif when == "recovered":
                    cond = ent.get("of", -1) in recovered
                else:
                    cond = False
                if cond and kp_armed is None:
                    kp_armed = now
                if (
                    kp_armed is not None
                    and now >= kp_armed + float(ent.get("delay_s", 0.0))
                ):
                    p = self._procs.get(int(ent["worker"]))
                    if (
                        p is not None and p.poll() is None
                        and int(ent["worker"]) not in pending_death
                    ):
                        sigkill(int(ent["worker"]))
                        killed_workers += 1
                    self._kp_idx += 1
                    kp_armed = None
            if now - last_liveness > spec.liveness_timeout_s:
                return fail("liveness timeout (no worker progress)")
            # per-worker wedge: heartbeats keep live workers' last_seen
            # fresh, so ONE silent worker while peers stream is a
            # single-worker fault, not a cluster wedge
            if partial_ok:
                for w in range(n):
                    if w in eos_rows or w in recovering:
                        continue
                    if now - last_seen.get(w, now) > spec.liveness_timeout_s:
                        r = begin_partial(
                            w,
                            f"worker {w} liveness timeout "
                            "(peers still streaming)",
                        )
                        if r is not None:
                            return r
            for w, info in list(recovering.items()):
                if now >= info["deadline"]:
                    return fail(
                        f"worker {w} rejoin exceeded "
                        f"{spec.rejoin_timeout_s}s"
                    )
            # barrier cadence: serial (commit e before issuing e+1),
            # held while any worker is mid-rejoin or its death is
            # pending; aborted epoch numbers are never reused within
            # this incarnation
            if (
                self._checkpointing()
                and len(ready) == n
                and not recovering
                and not pending_death
                and inflight_epoch is None
                and next_barrier_at is not None
                and now >= next_barrier_at
                and len(eos_rows) < n
            ):
                inflight_epoch = max([committed] + aborted) + 1
                acked = set()
                self._broadcast(
                    {"cmd": "barrier", "epoch": inflight_epoch}
                )
            try:
                kind, wid, msg, token, wtok = self._events.get(
                    timeout=0.05
                )
            except queue.Empty:
                continue
            if (
                token != self._gen_token
                or wtok != self._wgen.get(wid, 0)
            ):
                continue  # a dead generation/incarnation's event
            last_liveness = time.monotonic()
            last_seen[wid] = last_liveness
            if kind == "hello":
                continue
            if kind == "conn_lost":
                # the process-death poll above decides whether this is a
                # crash (nonzero exit) or a clean shutdown
                continue
            ev = msg.get("ev")
            if ev == "ready":
                if wid in self._spawned_at:
                    self.startup_s[wid] = round(
                        time.perf_counter() - self._spawned_at[wid], 4
                    )
                    self.startups.append({
                        "worker": wid, "seq": seq,
                        "gen": self._wgen.get(wid, 0),
                        "s": self.startup_s[wid],
                    })
                if wid in recovering:
                    # rejoin handshake: the respawn must echo exactly
                    # the partition subset this slot owns — anything
                    # else means it computed a different assignment
                    # and would double- or under-replay
                    npart = int(msg.get("n_partitions") or 0)
                    if list(msg.get("partitions") or []) != (
                        partitions_for(wid, n, npart)
                    ):
                        return fail(
                            f"worker {wid} rejoin echoed wrong "
                            "partition subset"
                        )
                    info = recovering.pop(wid)
                    ms = (time.perf_counter() - info["t0"]) * 1000.0
                    self.recoveries.append(
                        {"worker": wid, "ms": round(ms, 3)}
                    )
                    self._obs_recovery.observe(ms)
                    recovered.add(wid)
                    # peers whose ingest already ended send nothing that
                    # could fail and redial: tell them to replay their
                    # edge's buffered tail to the new incarnation
                    for w, wc in list(self._conns.items()):
                        if w != wid:
                            wc.send({"cmd": "rejoin", "worker": wid})
                    write_state()
                ready[wid] = msg
                if len(ready) == n:
                    if not recovering:
                        all_ready_at = time.monotonic()
                    if self.read_manifest() is None:
                        self._write_manifest({
                            "n_workers": n,
                            "store_version": store_version,
                            "n_partitions": msg.get("n_partitions"),
                            "state_keys": msg.get("state_keys"),
                            "key_columns": msg.get("key_columns"),
                            "key_dtypes": msg.get("key_dtypes"),
                        })
                    if self._checkpointing():
                        next_barrier_at = (
                            time.monotonic() + spec.checkpoint_interval_s
                        )
                    write_state()
            elif ev == "ack":
                ep = int(msg["epoch"])
                last_ack[wid] = max(ep, last_ack.get(wid, 0))
                if ep == inflight_epoch:
                    acked.add(wid)
                    if len(acked) == n:
                        committed = inflight_epoch
                        _fsync_append(self._commits_path, json.dumps({
                            "epoch": committed,
                            "n_workers": n,
                            "store_version": store_version,
                            "t": round(time.time(), 3),
                        }))
                        inflight_epoch = None
                        # senders prune replay buffers through the
                        # cluster-committed barrier — a partial rejoin
                        # never needs frames older than this cut
                        self._broadcast(
                            {"cmd": "committed", "epoch": committed}
                        )
                        next_barrier_at = (
                            time.monotonic() + spec.checkpoint_interval_s
                        )
                        write_state()
                        if (
                            self.kill_after_commits is not None
                            and len(self.committed_epochs())
                            >= self.kill_after_commits
                        ):
                            self._kill_all()
                            return "killed", {}
                        if len(eos_rows) == n:
                            # every worker reached EOS while this epoch
                            # was aligning — finish now that it committed
                            self._broadcast({"cmd": "stop"})
                            for p in self._procs.values():
                                try:
                                    p.wait(timeout=30)
                                except subprocess.TimeoutExpired:
                                    p.kill()
                            return "done", {
                                "rows": eos_rows,
                                "meta": eos_meta,
                                "killed_workers": (
                                    killed_workers + already_killed
                                ),
                            }
            elif ev == "eos":
                eos_rows[wid] = int(msg.get("rows", 0))
                eos_meta[wid] = msg
                if len(eos_rows) == n and inflight_epoch is None:
                    self._broadcast({"cmd": "stop"})
                    deadline = time.monotonic() + 30
                    for p in self._procs.values():
                        try:
                            p.wait(
                                timeout=max(0.1, deadline - time.monotonic())
                            )
                        except subprocess.TimeoutExpired:
                            p.kill()
                    return "done", {
                        "rows": eos_rows,
                        "meta": eos_meta,
                        "killed_workers": killed_workers + already_killed,
                    }
            elif ev == "error":
                pending_death.pop(wid, None)
                why = f"worker {wid}: {msg.get('msg')}"
                if msg.get("fallback") == "cluster":
                    # the worker itself determined single-worker replay
                    # cannot be exact (replay-buffer gap, unstamped
                    # ledgers) — only the full cut is sound
                    return fail(why)
                r = begin_partial(wid, why)
                if r is not None:
                    return r


def run_cluster(spec: ClusterSpec, **kw) -> dict:
    """Convenience wrapper: build a coordinator, run, return summary."""
    return Coordinator(spec, **kw).run()
