"""Long-running soak of the PyTorch/CUDA port (``denormalized_tpu_torch``)
on its device: one checkpointed streaming job, paced for minutes,
SIGKILLed and restored again and again, held to a numpy golden, with the
card's memory, the process's RSS and the hand kernels' launches recorded.

    python tools/torch_soak.py [--pipeline simple|sliding|join|session|udaf|
                                kafka|approx|query_dense|join_dense]
                               [--chaos] [--device cuda|cpu]
                               [--minutes 12] [--pace 200000]
                               [--kill-every 90] [--torch-threads N]
                               [--out PATH]
    python tools/torch_soak.py --pipeline bigstate [--keys 10000000]
                               [--wave-keys 100000] [--state-budget B]
                               [--ckpt-s 20] [--max-kills 2]
                               [--no-chaos-spill] [--kill-every 90] ...
    python tools/torch_soak.py --pipeline cluster [--cluster-workers 3]
                               [--cluster-partitions 6] [--partial]
                               [--minutes 12] [--batch-rows 4096]
                               [--kill-every 90] [--chaos-seed 1234] ...

The feed, the golden folds, the exactly-once reading of the segments'
output (epoch clipping), the chaos schedule and the dense query schedules
are those of the JAX package's soak (``tools/soak.py``, imported for its
pure helpers: that module loads only the standard library and numpy), so
both packages are held to one golden at one shape: 10 keys, 4,096-row
batches, 1 s windows, the same pace and seeds.  The approx golden folds
with the JAX package's numpy sketches, loaded by path
(``tools/soak.py::_sk``), so the port's HLL estimates are held to the
reference's with exact integer equality.

The child (``--child``, spawned by the parent for every segment) imports
``torch`` and ``denormalized_tpu_torch`` only, never ``jax`` nor
``denormalized_tpu``, and runs ``EngineConfig(device=--device)``, ``cuda``
by default: a child that finds no card, or cannot load a kernel, exits
non-zero; nothing falls back to the CPU.  Besides its window lines it
writes, into the same file so that a SIGKILLed segment leaves them behind:

- a ``ready`` line: the device's name, the seconds from spawn to the
  imports done, to the CUDA context ready and to the three kernel
  libraries loaded, and the child's RSS then (its fixed part);
- a ``device`` line once a second: ``torch.cuda.memory_allocated``,
  ``memory_reserved``, ``max_memory_allocated``, the child's RSS and the
  launch counters of ``ops/dense_window.py``, ``ops/merge_partials.py``
  and ``ops/compact_slot.py``;
- at its exit, the ``jax``/``denormalized_tpu`` modules it holds (none).

The parent builds every kernel once before the first spawn (one ``nvcc``
a source, in parallel; ``--no-build`` when the caller has), samples the
child's RSS, kills it ``--kill-every`` seconds after its ready line (not
its spawn: on the card the imports and the CUDA context take 6-11 s; no
kill once the child has read its feed's end or the feed's length has
passed since the first child was ready), respawns it, and reports per
segment the start-up split, device memory and RSS at the first emission,
at the maximum and at the end (and their slopes), and the launches.
``--torch-threads`` bounds each child's torch threads (the CPU tests pass
1: several soaks share their host).  Gates: those of ``tools/soak.py`` (0 windows lost, spurious or
mismatched, the emitted windows equal to the golden's, EOS seen, at least
one kill, every recovery to a first emission under 30 s), plus two on the
device (``device_gates``): the memory bound below, and every restored
segment launching exactly the hand kernels the first segment launched.
The parent exits 1 when a gate fails.

``--pipeline bigstate`` is ``tools/soak.py::bigstate_main`` (the cold
tier, larger-than-memory session state, under SIGKILLs and the spill-site
fault plan): see ``run_bigstate``.  Its child writes its ready, device,
``state`` (``state_info()``, the committed epoch and where the RSS goes,
``memory_owners``, once a second) and chaos lines to
``<segment>.jsonl.state``, beside the session lines.

``--pipeline cluster`` is ``tools/soak.py::cluster_main`` (the job over
worker processes, a torn exchange frame and a SIGKILL, in a full-restart
and a partial-recovery cell): see ``cluster_cell``.  The oracle runs in this
process and the workers on ``--device``; this process and the workers
import ``torch`` and ``denormalized_tpu_torch`` only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools import soak as S  # noqa: E402  (standard library + numpy)

PIPELINES = ("simple", "sliding", "join", "session", "udaf", "kafka",
             "approx", "query_dense", "join_dense", "bigstate", "cluster")
RECOVERY_LIMIT_S = 30.0
#: bigstate: rows a close wave (sessions each wave opens and keeps open)
BIGSTATE_WAVE_ROWS = 64

#: device-memory gate.  A segment that ran at least MEM_MIN_RUN_S past its
#: first emission must keep ``memory_allocated`` over its last MEM_TAIL_S
#: within MEM_REL x its value MEM_REF_AT_S after the first emission, plus
#: MEM_ABS_BYTES.  Why this bound: after warm-up the live bytes on the card
#: are set by the job's shape (the window ring, W slots x G groups, and the
#: few batches in flight), not by its age; 10% covers one growth step of
#: the ring's slots and the 16 MiB the batches in flight, the pinned
#: staging's device side and the compaction scratch, so a buffer leaked
#: every batch or every window (thousands of each over a minute) crosses it.
MEM_MIN_RUN_S = 60.0
MEM_REF_AT_S = 30.0
MEM_TAIL_S = 10.0
MEM_REL = 0.10
MEM_ABS_BYTES = 16 << 20
MEM_BOUND_REASON = (
    "after warm-up the card's live bytes are set by the job's shape (ring "
    "W x G, batches in flight), not its age: 10% covers a ring growth "
    "step, 16 MiB the in-flight batches and cached scratch; a buffer "
    "leaked a batch or a window crosses it within the minute"
)


def _foreign_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(
        m for m in sys.modules
        if m in ("jax", "jaxlib", "denormalized_tpu")
        or m.startswith(("jax.", "jaxlib.", "denormalized_tpu."))
    )


# -- child ---------------------------------------------------------------


class _Out:
    """The segment's line-buffered output, shared by the emission loop and
    the device sampler thread (one lock, so lines never interleave)."""

    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def event(self, obj: dict) -> None:
        line = json.dumps(obj) + "\n"
        with self._lock:
            self._f.write(line)

    def close(self) -> None:
        with self._lock:
            self._f.close()


def _device_startup(torch, device: str, spawn_t: float) -> dict:
    """CUDA context and kernel libraries up front, timed from the spawn.
    Exits non-zero when the device is a card and there is none; a kernel
    library that does not build or load raises."""
    info: dict = {"imports_s": round(time.time() - spawn_t, 3),
                  "torch": torch.__version__}
    dev = torch.device(device)
    if dev.type != "cuda":
        info.update(device_name=str(dev), cuda_ready_s=None,
                    kernels_loaded_s=None)
        return info
    if not torch.cuda.is_available():
        print("torch_soak child: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        sys.exit(3)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    info["cuda_ready_s"] = round(time.time() - spawn_t, 3)
    from denormalized_tpu_torch.ops import cuda_build

    for name in cuda_build.sources():
        cuda_build.load(name)
    info["kernels_loaded_s"] = round(time.time() - spawn_t, 3)
    info["device_name"] = torch.cuda.get_device_name(dev)
    return info


def _launches() -> dict:
    from denormalized_tpu_torch.ops import compact_slot, dense_window
    from denormalized_tpu_torch.ops import merge_partials

    return {
        "dense_window": dense_window.dense_window_launches,
        "merge_partials": merge_partials.merge_partials_launches,
        "compact_slot": compact_slot.compact_slot_launches,
    }


def _device_record(torch, device: str) -> dict:
    dev = torch.device(device)
    rec: dict = {"event": "device", "t": time.time()}
    if dev.type == "cuda":
        rec["alloc"] = torch.cuda.memory_allocated(dev)
        rec["reserved"] = torch.cuda.memory_reserved(dev)
        rec["max_alloc"] = torch.cuda.max_memory_allocated(dev)
    else:
        rec["alloc"] = rec["reserved"] = rec["max_alloc"] = None
    rec["rss_kb"] = S.rss_kb(os.getpid())
    rec["launches"] = _launches()
    return rec


class _MallInfo2(ctypes.Structure):
    """glibc's ``struct mallinfo2``: every field a ``size_t``."""

    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _mallinfo() -> dict:
    """glibc's heap over every arena: ``arena_kb`` (bytes taken from the
    system outside mmapped chunks), ``in_use_kb``, ``free_held_kb`` (freed
    and kept by the allocator) and ``mmap_kb``; empty off glibc."""
    try:
        fn = ctypes.CDLL(None).mallinfo2
    except (OSError, AttributeError):
        return {}
    fn.restype = _MallInfo2
    m = fn()
    return {"arena_kb": m.arena >> 10, "in_use_kb": m.uordblks >> 10,
            "free_held_kb": m.fordblks >> 10, "mmap_kb": m.hblkhd >> 10}


def _smaps_rollup() -> dict:
    """``Rss``, ``Anonymous`` and ``Private_Dirty`` of this process, kB."""
    want = {"Rss": "rss_kb", "Anonymous": "anon_kb",
            "Private_Dirty": "private_dirty_kb"}
    out: dict = {}
    try:
        with open("/proc/self/smaps_rollup") as f:
            for line in f:
                name, _, rest = line.partition(":")
                if name in want:
                    out[want[name]] = int(rest.split()[0])
    except OSError:
        pass
    return out


def memory_owners(op) -> dict:
    """Where a session job's RSS goes: the process's anonymous and dirty
    pages, glibc's heap, the session table's arrays, the interner's keys
    (count and the tier's estimate), the keys of the LSM store's in-memory
    index (it buffers no values: each put is appended to its segment file)
    and the operator's last checkpoint document."""
    from denormalized_tpu_torch.obs import statewatch

    tier = op._tier
    store = tier.ctrl.backend if tier is not None else None
    keys = len(op._interner)
    return {
        **_smaps_rollup(), **_mallinfo(),
        "table_bytes": op._table.capacity_nbytes(),
        "interner_keys": keys,
        "interner_est_bytes": keys * statewatch.KEY_EST_BYTES,
        "lsm_keys": len(store) if store is not None else None,
        "ckpt_doc_bytes": op.last_snapshot_bytes,
    }


def _start_device_sampler(out: _Out, torch, device: str, extra=None):
    """A device line now and once a second until the returned event is
    set, each followed by the lines ``extra()`` returns (if given)."""
    stop = threading.Event()
    out.event(_device_record(torch, device))

    def run():
        while not stop.wait(1.0):
            out.event(_device_record(torch, device))
            for ev in (extra() if extra is not None else ()):
                out.event(ev)

    threading.Thread(target=run, daemon=True, name="soak-device").start()
    return stop


def child_main() -> None:
    spawn_t = float(os.environ.get("SOAK_SPAWN_T") or time.time())
    device = os.environ.get("SOAK_DEVICE", "cuda")
    import torch

    threads = int(os.environ.get("SOAK_TORCH_THREADS") or 0)
    if threads:
        torch.set_num_threads(threads)
    from denormalized_tpu_torch import Context, EngineConfig, col
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.common.constants import (
        WINDOW_END_COLUMN,
        WINDOW_START_COLUMN,
    )
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema
    from denormalized_tpu_torch.sources.base import (
        PartitionReader,
        Source,
        attach_canonical_timestamp,
        canonicalize_schema,
    )

    startup = _device_startup(torch, device, spawn_t)
    pipeline = os.environ.get("SOAK_PIPELINE", "simple")
    batch_rows = int(os.environ["SOAK_BATCH_ROWS"])
    pace = float(os.environ["SOAK_PACE"])
    total_batches = int(os.environ["SOAK_TOTAL_BATCHES"])
    ckpt_dir = os.environ["SOAK_CKPT_DIR"]
    out_path = os.environ["SOAK_OUT"]
    n_keys = S.N_KEYS

    schema = Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])
    key_names = np.array([f"sensor_{k}" for k in range(n_keys)], dtype=object)

    class SoakPartition(PartitionReader):
        """The JAX soak's deterministic paced feed: batch i regenerates
        from its index, so ``offset_restore`` is a fast-forward; pacing
        re-anchors at the restored index."""

        def __init__(self, seed):
            self._seed = seed
            self._i = 0
            self._eof = False
            self._anchor_wall = None
            self._anchor_i = 0

        def read(self, timeout_s=None):
            if self._i >= total_batches:
                if not self._eof:
                    # the feed is read: the parent kills no more from here
                    self._eof = True
                    out.event({"event": "eof", "t": time.time()})
                return None
            now = time.monotonic()
            if self._anchor_wall is None:
                self._anchor_wall = now
                self._anchor_i = self._i
            due = self._anchor_wall + (
                (self._i - self._anchor_i) * batch_rows / pace
            )
            if now < due:
                time.sleep(min(due - now, timeout_s or (due - now)))
                if time.monotonic() < due:
                    return attach_canonical_timestamp(
                        RecordBatch.empty(schema), "occurred_at_ms",
                        fallback_ms=int(time.time() * 1000),
                    )
            if pipeline == "join":
                ts, keys, vals = S.join_batch_arrays(
                    self._i, batch_rows, pace, total_batches
                )
            elif pipeline == "join_dense":
                ts, keys, vals = S.jd_batch_arrays(self._i, batch_rows, pace)
            else:
                ts, keys, vals = S.batch_arrays(
                    self._i, batch_rows, pace, seed=self._seed
                )
            if pipeline == "session":
                ts = S.burst_ts(ts)
            self._i += 1
            b = RecordBatch(schema, [ts, key_names[keys], vals])
            return attach_canonical_timestamp(
                b, "occurred_at_ms", fallback_ms=int(time.time() * 1000)
            )

        def offset_snapshot(self):
            return {"i": self._i}

        def offset_restore(self, snap):
            self._i = int(snap["i"])
            self._anchor_wall = None

    canon = canonicalize_schema(schema)

    class SoakSource(Source):
        def __init__(self, seed, name):
            self._seed = seed
            self.name = name

        @property
        def schema(self):
            return canon

        def partitions(self):
            return [SoakPartition(self._seed)]

        @property
        def unbounded(self):
            return False

    cfg = EngineConfig(
        device=device,
        min_batch_bucket=batch_rows,
        min_window_slots=32,
        checkpoint=True,
        checkpoint_interval_s=float(os.environ.get("SOAK_CKPT_S", 2.0)),
        state_backend_path=ckpt_dir,
        emit_on_close=True,
        source_idle_timeout_ms=int(
            os.environ.get("SOAK_IDLE_MS", 1000)
        ) or None,
        metrics_jsonl_path=os.environ.get("SOAK_OBS_OUT"),
        metrics_jsonl_interval_s=1.0,
    )
    ctx = Context(cfg)

    def coordinator():
        return ctx.last_checkpointing()[0]

    def qd_aggs():
        # the foldable set minus variance, as the JAX soak's
        return [
            F.count(col("reading")).alias("count"),
            F.sum(col("reading")).alias("sum"),
            F.min(col("reading")).alias("min"),
            F.max(col("reading")).alias("max"),
            F.avg(col("reading")).alias("average"),
        ]

    dim_user = Schema([
        Field("dim_at_ms", DataType.INT64, nullable=False),
        Field("dim_sensor", DataType.STRING, nullable=False),
        Field("w", DataType.FLOAT64),
    ])
    dim_schema = canonicalize_schema(dim_user)
    dim_seconds = -(-total_batches * batch_rows // int(pace)) + 1
    t0_sec = S.T0 // 1000

    class DimPartition(PartitionReader):
        """One batch an event-second: ``n_keys`` enrichment rows at the
        second's boundary, paced at one batch a wall second
        (``paced=False`` replays densely for the oracle)."""

        def __init__(self, paced=True):
            self._paced = paced
            self._i = 0
            self._anchor_wall = None
            self._anchor_i = 0

        def read(self, timeout_s=None):
            if self._i >= dim_seconds:
                return None
            if self._paced:
                now = time.monotonic()
                if self._anchor_wall is None:
                    self._anchor_wall = now
                    self._anchor_i = self._i
                due = self._anchor_wall + (self._i - self._anchor_i)
                if now < due:
                    time.sleep(min(due - now, timeout_s or (due - now)))
                    if time.monotonic() < due:
                        return attach_canonical_timestamp(
                            RecordBatch.empty(dim_user), "dim_at_ms",
                            fallback_ms=int(time.time() * 1000),
                        )
            s = self._i
            self._i += 1
            ts = np.full(n_keys, (t0_sec + s) * 1000, dtype=np.int64)
            vals = np.array([S.dim_value(k, s) for k in range(n_keys)])
            b = RecordBatch(dim_user, [ts, key_names.copy(), vals])
            return attach_canonical_timestamp(
                b, "dim_at_ms", fallback_ms=int(time.time() * 1000)
            )

        def offset_snapshot(self):
            return {"i": self._i}

        def offset_restore(self, snap):
            self._i = int(snap["i"])
            self._anchor_wall = None

    class DimSource(Source):
        name = "soak_dim"

        def __init__(self, paced=True):
            self._paced = paced

        @property
        def schema(self):
            return dim_schema

        def partitions(self):
            return [DimPartition(self._paced)]

        @property
        def unbounded(self):
            return False

    from denormalized_tpu_torch.runtime import faults as fault_mod

    fault_lines_seen = 0

    def bigstate_lines() -> list[dict]:
        """The session operator's state accounting (``state_info``) and
        the coordinator's committed epoch, and the fault log whenever it
        grew: once a second, since phase A emits nothing for minutes."""
        nonlocal fault_lines_seen
        from denormalized_tpu_torch.physical.session_exec import (
            SessionWindowExec,
        )

        lines = []
        # the job's operators exist once ds.stream() has built them
        root = getattr(ctx, "_last_physical", None)
        stack = [root] if root is not None else []
        while stack:
            op = stack.pop()
            if isinstance(op, SessionWindowExec):
                try:
                    info = op.state_info()
                except Exception:  # dnzlint: allow(broad-except) a read racing the operator's writer skips a sample
                    break
                coord = coordinator()
                lines.append({
                    "event": "state", "t": time.time(),
                    "bytes": info.get("state_bytes"),
                    "evictable": info.get("evictable_bytes"),
                    "live_keys": info.get("live_keys"),
                    "spilled_bytes": info.get("spilled_bytes", 0),
                    "spilled_keys": info.get("spilled_keys", 0),
                    "spilled_blocks": info.get("spilled_blocks", 0),
                    "spill": info.get("spill"),
                    "committed_epoch": (coord.committed_epoch
                                        if coord is not None else None),
                    "mem": memory_owners(op),
                })
                break
            stack.extend(op.children)
        plan = fault_mod.plan()
        if plan is not None and len(plan.events) > fault_lines_seen:
            fault_lines_seen = len(plan.events)
            lines.append({"event": "chaos", "fault_log": plan.event_log()})
        return lines

    out = _Out(out_path)
    # bigstate's ready, device, state and chaos lines go to a file of their
    # own, so the parent reads them without parsing millions of sessions
    side = _Out(out_path + ".state") if pipeline == "bigstate" else out
    # the RSS at the ready line is the process's fixed part (imports, the
    # CUDA context, the kernel libraries), taken before the first batch
    side.event({"event": "ready", "t": time.time(),
                "rss_kb": S.rss_kb(os.getpid()), **startup,
                **({"mem": {**_smaps_rollup(), **_mallinfo()}}
                   if pipeline == "bigstate" else {})})
    sampler = _start_device_sampler(
        side, torch, device,
        extra=bigstate_lines if pipeline == "bigstate" else None)

    def finish(extra=None):
        sampler.set()
        side.event(_device_record(torch, device))
        done = {"event": "done", "t": time.time(),
                "foreign_modules": _foreign_modules(), **(extra or {})}
        out.event(done)
        out.close()
        if side is not out:
            side.event(done)
            side.close()

    if pipeline in ("query_dense", "join_dense"):
        # the JAX soak's live multi-query registry: the schedule is event
        # time keyed, so every incarnation re-issues it verbatim (restored
        # subscribers adopt their cursors, departed tags stay departed)
        from denormalized_tpu_torch.runtime.multi_query import SharedPipeline

        if pipeline == "join_dense":
            cfg.join_retention_ms = S.JD_RETENTION_MS
            cfg.join_band_slack_ms = 0
            sched = S.jd_schedule(total_batches, batch_rows, pace)
            unit_ms = S.JD_UNIT_MS
            fact = ctx.from_source(
                SoakSource(S.SEED_LEFT, "soak_fact"), name="soak_fact"
            )
            dim = ctx.from_source(DimSource(), name="soak_dim")
            base = fact.join(
                dim, "inner", ["sensor_name"], ["dim_sensor"],
                band=("occurred_at_ms", "dim_at_ms", 0, S.JOIN_BAND_MS - 1),
            )
        else:
            sched = S.qd_schedule(total_batches, batch_rows, pace)
            unit_ms = S.QD_UNIT_MS
            base = ctx.from_source(
                SoakSource(S.SEED_LEFT, "soak_qd"), name="soak_qd"
            )
        aggs = qd_aggs()

        def q_stream(spec):
            return base.filter(col("reading") > spec["thr"]).window(
                ["sensor_name"], aggs, spec["L"], spec["S"]
            )

        announced: list = []

        def mk_sink(qid):
            def sink(b):
                coord = coordinator()
                if not announced:
                    announced.append(True)
                    out.event({
                        "event": "restored",
                        "epoch": ((coord.restored_epoch or 0)
                                  if coord is not None else None),
                    })
                ep = ((coord.committed_epoch or 0) + 1
                      if coord is not None else None)
                ws = b.column(WINDOW_START_COLUMN)
                names = b.column("sensor_name")
                cols = [b.column(c)
                        for c in ("count", "sum", "min", "max", "average")]
                for i in range(b.num_rows):
                    rec = {
                        "q": qid, "ws": int(ws[i]), "key": str(names[i]),
                        "count": int(cols[0][i]), "sum": float(cols[1][i]),
                        "min": float(cols[2][i]), "max": float(cols[3][i]),
                        "avg": float(cols[4][i]),
                    }
                    if ep is not None:
                        rec["ep"] = ep
                    out.event(rec)
            return sink

        initial = [s for s in sched if "join" not in s]
        sp = SharedPipeline(
            ctx,
            [(q_stream(s), mk_sink(s["qid"])) for s in initial],
            labels=[f"q{s['qid']}" for s in initial],
        )
        assert sp.root.unit_ms == unit_ms, sp.root.unit_ms
        out.event({"event": "build", "t": time.time()})
        for s in sched:
            if "join" in s:
                tag = sp.register(q_stream(s), mk_sink(s["qid"]),
                                  label=f"q{s['qid']}", when_ts=s["join"])
                assert tag == s["qid"], (tag, s["qid"])
        for s in sched:
            if "leave" in s:
                sp.deregister(s["qid"], when_ts=s["leave"])
        sp.run()
        m = sp.root.metrics()
        out.event({"event": "metrics", **{
            k: v for k, v in m.items() if isinstance(v, (int, float))
        }})
        finish()
        return

    if pipeline in ("query_dense_oracle", "join_dense_oracle"):
        # per-query independent uninterrupted runs over the same feed,
        # replayed densely, pinned to the shared group's unit: the
        # byte-identity referent of the live shared run
        from denormalized_tpu_torch.sources.memory import MemorySource

        joined = pipeline == "join_dense_oracle"
        sched = (S.jd_schedule(total_batches, batch_rows, pace) if joined
                 else S.qd_schedule(total_batches, batch_rows, pace))
        feed = []
        for i in range(total_batches):
            if joined:
                ts, keys, vals = S.jd_batch_arrays(i, batch_rows, pace)
            else:
                ts, keys, vals = S.batch_arrays(i, batch_rows, pace,
                                                seed=S.SEED_LEFT)
            feed.append(RecordBatch(schema, [ts, key_names[keys], vals]))
        for spec in sched:
            ocfg = EngineConfig(
                device=device,
                min_batch_bucket=batch_rows,
                min_window_slots=32,
                slice_windows=True,
                slice_unit_ms=S.JD_UNIT_MS if joined else S.QD_UNIT_MS,
                emit_on_close=True,
            )
            if joined:
                ocfg.join_retention_ms = S.JD_RETENTION_MS
                ocfg.join_band_slack_ms = 0
            octx = Context(ocfg)
            src = octx.from_source(
                MemorySource.from_batches(
                    feed, timestamp_column="occurred_at_ms"),
                name="soak_fact" if joined else "soak_qd",
            )
            if joined:
                src = src.join(
                    octx.from_source(DimSource(paced=False), name="soak_dim"),
                    "inner", ["sensor_name"], ["dim_sensor"],
                    band=("occurred_at_ms", "dim_at_ms", 0,
                          S.JOIN_BAND_MS - 1),
                )
            ds = src.filter(col("reading") > spec["thr"]).window(
                ["sensor_name"], qd_aggs(), spec["L"], spec["S"]
            )
            for b in ds.stream():
                if not b.schema.has(WINDOW_START_COLUMN):
                    continue
                ws = b.column(WINDOW_START_COLUMN)
                names = b.column("sensor_name")
                cols = [b.column(c)
                        for c in ("count", "sum", "min", "max", "average")]
                for i in range(b.num_rows):
                    out.event({
                        "q": spec["qid"], "ws": int(ws[i]),
                        "key": str(names[i]), "count": int(cols[0][i]),
                        "sum": float(cols[1][i]), "min": float(cols[2][i]),
                        "max": float(cols[3][i]), "avg": float(cols[4][i]),
                    })
        finish()
        return

    last_close_ws = (int(os.environ["SOAK_LAST_CLOSE_WS"])
                     if pipeline == "kafka" else None)
    if pipeline == "kafka":
        # broker -> native wire client -> native JSON decode -> window;
        # offsets restored by seek, the feed running on across kills
        ds = ctx.from_topic(
            "soak", schema=schema,
            bootstrap_servers=os.environ["SOAK_BOOTSTRAP"],
            timestamp_column="occurred_at_ms",
        ).window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            S.WINDOW_MS,
        )
    elif pipeline == "udaf":
        from denormalized_tpu_torch.api.udaf import Accumulator

        class Spread(Accumulator):
            def __init__(self):
                self.lo = float("inf")
                self.hi = float("-inf")

            def update(self, values):
                if len(values):
                    self.lo = min(self.lo, float(values.min()))
                    self.hi = max(self.hi, float(values.max()))

            def merge(self, states):
                self.lo = min(self.lo, states[0])
                self.hi = max(self.hi, states[1])

            def state(self):
                return [self.lo, self.hi]

            def evaluate(self):
                return self.hi - self.lo if self.hi >= self.lo else 0.0

        spread = F.udaf(Spread, DataType.FLOAT64, "spread")
        ds = ctx.from_source(
            SoakSource(S.SEED_LEFT, "soak_u"), name="soak_u"
        ).window(
            ["sensor_name"],
            [spread(col("reading")).alias("spread"),
             F.count(col("reading")).alias("count")],
            S.WINDOW_MS,
        )
    elif pipeline == "approx":
        cfg.slice_windows = True
        cfg.slice_unit_ms = S.SLIDE_MS  # kills land mid-window, mid-slice
        ds = ctx.from_source(
            SoakSource(S.SEED_LEFT, "soak_ax"), name="soak_ax"
        ).window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.approx_distinct(col("reading")).alias("distinct")],
            S.WINDOW_MS,
        )
    elif pipeline == "bigstate":
        # the JAX soak's larger-than-memory sessions: phase A opens
        # SOAK_BS_KEYS singleton sessions (gap = phase A's event span, so
        # all stay open at once), phase B advances the watermark in waves
        # of SOAK_BS_WAVE keys (64 rows a wave) so sessions close a wave at
        # a time.  A budgeted child (SOAK_BS_BUDGET > 0) runs the cold tier
        # and checkpoints; the reference child runs the same feed with
        # neither
        bs_keys = int(os.environ["SOAK_BS_KEYS"])
        bs_wave = int(os.environ["SOAK_BS_WAVE"])
        bs_budget = int(os.environ.get("SOAK_BS_BUDGET") or 0)
        if bs_budget:
            cfg.state_budget_bytes = bs_budget
        else:
            cfg.checkpoint = False
        bs_gap = bs_keys  # 1 ms a key
        a_batches = -(-bs_keys // batch_rows)
        waves = -(-bs_keys // bs_wave)
        bs_user = Schema([
            Field("occurred_at_ms", DataType.INT64, nullable=False),
            Field("sensor_id", DataType.INT64, nullable=False),
            Field("reading", DataType.FLOAT64),
        ])
        bs_schema = canonicalize_schema(bs_user)

        class BigstatePartition(PartitionReader):
            """Batch i regenerates from its index (restore = fast-forward);
            unpaced."""

            def __init__(self):
                self._i = 0

            def read(self, timeout_s=None):
                i = self._i
                if i >= a_batches + waves:
                    return None
                self._i += 1
                if i < a_batches:
                    lo = i * batch_rows
                    kids = np.arange(lo, min(lo + batch_rows, bs_keys),
                                     dtype=np.int64)
                    ts = S.T0 + kids
                else:
                    j = i - a_batches + 1
                    base = bs_keys + (j - 1) * BIGSTATE_WAVE_ROWS
                    kids = np.arange(base, base + BIGSTATE_WAVE_ROWS,
                                     dtype=np.int64)
                    ts = np.full(BIGSTATE_WAVE_ROWS,
                                 S.T0 + bs_gap + j * bs_wave, dtype=np.int64)
                vals = (kids % 997) * 0.5 + 1.0
                return attach_canonical_timestamp(
                    RecordBatch(bs_user, [ts, kids, vals]), "occurred_at_ms",
                    fallback_ms=int(time.time() * 1000))

            def offset_snapshot(self):
                return {"i": self._i}

            def offset_restore(self, snap):
                self._i = int(snap["i"])

        class BigstateSource(Source):
            name = "bigstate"

            @property
            def schema(self):
                return bs_schema

            def partitions(self):
                return [BigstatePartition()]

            @property
            def unbounded(self):
                return False

        ds = ctx.from_source(BigstateSource(), name="bigstate").session_window(
            ["sensor_id"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            bs_gap,
        )
    elif pipeline == "session":
        ds = ctx.from_source(
            SoakSource(S.SEED_LEFT, "soak_s"), name="soak_s"
        ).session_window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            S.SESSION_GAP_MS,
        )
    elif pipeline == "join":
        # the skewed, late fact stream band-joined to the per-second
        # dimension stream, then windowed (the JAX soak's join)
        cfg.join_retention_ms = S.JOIN_RETENTION_MS
        cfg.join_band_slack_ms = S.JOIN_LATE_MS
        left = ctx.from_source(
            SoakSource(S.SEED_LEFT, "soak_fact"), name="soak_fact"
        )
        right = ctx.from_source(DimSource(), name="soak_dim")
        ds = left.join(
            right, "inner", ["sensor_name"], ["dim_sensor"],
            band=("occurred_at_ms", "dim_at_ms", 0, S.JOIN_BAND_MS - 1),
        ).window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.avg(col("reading")).alias("avg_t"),
             F.avg(col("w")).alias("avg_h")],
            S.WINDOW_MS,
        )
    else:
        ds = ctx.from_source(
            SoakSource(S.SEED_LEFT, "soak"), name="soak"
        ).window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            S.WINDOW_MS,
            S.SLIDE_MS if pipeline == "sliding" else None,
        )
    it = ds.stream()
    stop = False
    coord = None
    announced = False
    last_chaos_write = 0.0
    chaos_log_seen = 0

    def write_chaos_event() -> None:
        """Self-healing and fault state, rewritten every few seconds so a
        SIGKILLed segment leaves its (nearly) final fault log behind."""
        from denormalized_tpu_torch.common.errors import StateError
        from denormalized_tpu_torch.runtime import faults
        from denormalized_tpu_torch.runtime.tracing import collect_metrics
        from denormalized_tpu_torch.state.lsm import get_global_state_backend

        chaos: dict = {}
        if coord is not None:
            chaos["commit_retries"] = coord.commit_retries
            chaos["restored_from_fallback"] = bool(
                coord.restored_from_fallback)
        try:
            chaos["replay_truncated"] = int(
                get_global_state_backend().replay_truncated)
        except StateError:  # no store yet: nothing to report
            pass
        if ctx._last_physical is not None:
            chaos["prefetch_restarts"] = sum(
                m.get("prefetch_restarts", 0)
                for m in collect_metrics(ctx._last_physical).values()
            )
        p = faults.plan()
        if p is not None:
            chaos["fault_log"] = p.event_log()
        if chaos:
            side.event({"event": "chaos", **chaos})

    for batch in it:
        # chaos state every 5 s and whenever the fault log grew, so an
        # injection just before a SIGKILL stays in the segment's record
        mono = time.monotonic()
        plan = fault_mod.plan()
        log_len = len(plan.events) if plan is not None else 0
        if mono - last_chaos_write > 5.0 or log_len > chaos_log_seen:
            last_chaos_write = mono
            chaos_log_seen = log_len
            write_chaos_event()
        if not announced:
            # exactly-once output: the recovery point before any window
            # line (the parent clips the predecessor's uncommitted suffix)
            coord = coordinator()
            out.event({
                "event": "restored",
                "epoch": ((coord.restored_epoch or 0)
                          if coord is not None else None),
            })
            announced = True
        if not batch.schema.has(WINDOW_START_COLUMN):
            continue
        now = round(time.time(), 3)

        def column(name):
            return batch.column(name).tolist()

        ws = column(WINDOW_START_COLUMN)
        names = column("sensor_id" if pipeline == "bigstate"
                       else "sensor_name")
        counts = column("count")
        if pipeline == "udaf":
            cols = {"spread": column("spread")}
        elif pipeline == "join":
            cols = {"avg_t": column("avg_t"), "avg_h": column("avg_h")}
        elif pipeline == "approx":
            cols = {"distinct": column("distinct")}
        else:
            cols = {"min": column("min"), "max": column("max"),
                    "avg": column("average")}
            if pipeline in ("session", "bigstate"):
                cols["we"] = column(WINDOW_END_COLUMN)
        for i in range(batch.num_rows):
            rec = {"t": now, "ws": int(ws[i]),
                   "key": (int(names[i]) if pipeline == "bigstate"
                           else str(names[i])),
                   "count": int(counts[i])}
            for k, v in cols.items():
                rec[k] = (int(v[i]) if k in ("distinct", "we")
                          else round(float(v[i]), 4))
            if coord is not None:
                # in-flight epoch: committed once epoch `ep` commits
                rec["ep"] = (coord.committed_epoch or 0) + 1
            out.event(rec)
            if last_close_ws is not None and rec["ws"] >= last_close_ws:
                stop = True  # unbounded source: close at the target
        if stop:
            it.close()
            break
    from denormalized_tpu_torch.runtime.tracing import collect_metrics

    sums: dict = {}
    for m in collect_metrics(ctx._last_physical).values():
        for k, v in m.items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0) + v
    out.event({"event": "metrics", **{k: sums[k] for k in (
        "late_rows", "rows_out", "rows_in", "batches_out",
        "prefetch_restarts", "prefetch_restarted_partitions",
        "salvaged_rows", "hot_keys", "adaptations",
    ) if k in sums}})
    write_chaos_event()
    finish()


def build_main() -> None:
    """Build every CUDA kernel (one nvcc a source, all started together)
    and, meanwhile, the host libraries the pipelines load, so no segment
    pays a compiler."""
    import sysconfig
    from concurrent.futures import ThreadPoolExecutor

    from denormalized_tpu_torch.native.build import load as load_native
    from denormalized_tpu_torch.ops import cuda_build
    from denormalized_tpu_torch.ops.interner import native_interner

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (
            load_native("partial_agg"), native_interner(),
            load_native("lsmkv"), load_native("json_parser"),
            load_native("kafka_client", ("-lz",)),
            load_native("pyassemble", (
                f"-I{sysconfig.get_paths()['include']}",), pydll=True)))
        built = cuda_build.build_all()
        host.result()
    print(f"torch_soak: built {', '.join(sorted(built))} and the host "
          "libraries", file=sys.stderr)


# -- parent --------------------------------------------------------------


#: seconds before the Kafka feed's first append at which the first segment
#: is spawned (its start-up on the card takes ~10 s of them)
KAFKA_SPAWN_LEAD_S = 5.0


def kafka_prep_and_feed(args, total_batches, log):
    """``tools/soak.py::kafka_prep_and_feed`` over the port's mock broker:
    the parent-owned broker (the durable log that survives child kills),
    every chunk staged up front, event time re-anchored just past the
    staging's estimated end and each batch appended when the wall clock
    reaches its event time → (broker, last_close_ws, feed_anchor).  The
    estimate times three batches after a warm-up one (the JAX soak's times
    the first alone, whose one-time costs made a slow host's estimate ~4x
    long, so a run's first segments saw no rows)."""
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    parts = S.KAFKA_PARTS

    def stage(i, base):
        ts, keys, vals = S.batch_arrays(i, args.batch_rows, args.pace,
                                        seed=S.SEED_LEFT)
        rows = S.encode_json_rows(ts, keys, vals)
        return ts, [MockKafkaBroker.stage_batched(
            rows[p::parts], ts_ms=int(ts[0]),
            records_per_batch=len(rows[p::parts]), base_offset=base[p])
            for p in range(parts)]

    broker = MockKafkaBroker().start()
    broker.create_topic("soak", partitions=parts)
    stage(0, [0] * parts)  # warm-up
    n_cal = min(3, total_batches)
    t_cal = time.monotonic()
    for i in range(n_cal):
        stage(i, [0] * parts)
    per_batch = (time.monotonic() - t_cal) / max(n_cal, 1)
    est_s = per_batch * total_batches * 1.3 + 2.0
    if "SOAK_T0" not in os.environ:
        S.T0 = (int((time.time() + est_s) * 1000) // S.WINDOW_MS
                * S.WINDOW_MS)
    log(f"kafka soak: staging est {est_s:.0f}s, event origin T0={S.T0}")
    span_ms = int(total_batches * args.batch_rows * 1000.0 / args.pace)
    last_close_ws = ((S.T0 + span_ms) // S.WINDOW_MS - 2) * S.WINDOW_MS
    staged = [[] for _ in range(parts)]
    base = [0] * parts
    for i in range(total_batches):
        _ts, chunks = stage(i, base)
        for p in range(parts):
            staged[p].append(chunks[p])
            base[p] += len(chunks[p])
    log(f"kafka soak: staged {total_batches} chunks, "
        f"{S.T0 / 1000.0 - time.time():.1f} s before the feed starts")
    feed_anchor = {"epoch": S.T0 / 1000.0}

    def feed():
        t0_wall = S.T0 / 1000.0
        for i in range(total_batches):
            delay = t0_wall + (i + 1) * args.batch_rows / args.pace - time.time()
            if delay > 0:
                time.sleep(delay)
            for p in range(parts):
                broker.append_staged("soak", p, staged[p][i])

    threading.Thread(target=feed, daemon=True).start()
    return broker, last_close_ws, feed_anchor


def chaos_sim_sequence(spec: dict) -> list[dict]:
    """``tools/soak.py::chaos_sim_sequence`` on the port's ``FaultPlan``:
    a fresh plan through a fixed call sequence → its event log."""
    from denormalized_tpu_torch.common.errors import DenormalizedError
    from denormalized_tpu_torch.runtime.faults import FaultPlan

    p = FaultPlan(dict(spec))
    for i in range(1200):
        calls = [("kafka.fetch", "soak:0", None)]
        if i % 20 == 0:
            calls.append(("lsm.put", f"window_1@{1000 + i}", b"x" * 64))
        if i % 40 == 0:
            calls += [("checkpoint.commit", None, None),
                      ("lsm.flush", None, None)]
        for site, key, payload in calls:
            try:
                p.on(site, key=key, payload=payload)
            except DenormalizedError:  # an injected fault: the point
                pass
    return p.event_log()


def _port_obs_readers():
    """The port's stdlib-only telemetry readers, loaded by path (the
    parent does not import torch for them)."""
    import importlib.util

    path = REPO / "denormalized_tpu_torch" / "obs" / "readers.py"
    spec = importlib.util.spec_from_file_location("_torch_soak_readers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive_telemetry(obs_paths, anchor_epoch_ms=None) -> dict:
    """``tools/soak.py::derive_telemetry`` over the port's readers."""
    real = S._obs_readers
    S._obs_readers = _port_obs_readers
    try:
        return S.derive_telemetry(obs_paths, anchor_epoch_ms)
    finally:
        S._obs_readers = real


def dense_verify(args, env, work, wins, seg_paths, total_batches, *,
                 sched_fn, oracle_pipeline) -> dict:
    """``tools/soak.py::qd_verify`` with this tool's own oracle child (on
    the same device): every live query's committed emissions byte-identical
    to its independent uninterrupted run from its first exact window,
    warm backfills owed by continuous filter classes present, and one
    pipeline build a segment."""
    oracle_path = os.path.join(work, "qd_oracle.jsonl")
    oenv = dict(env, SOAK_PIPELINE=oracle_pipeline, SOAK_OUT=oracle_path,
                SOAK_SPAWN_T=str(time.time()))
    rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                          "--child"], env=oenv, stdout=sys.stderr,
                         stderr=sys.stderr)
    oracle: dict = {}
    if rc == 0:
        for o in _json_lines(oracle_path):
            if "ws" in o:
                oracle.setdefault(o["q"], {})[(o["key"], o["ws"])] = (
                    o["count"], o["sum"], o["min"], o["max"], o["avg"])
    builds = [sum(1 for o in _json_lines(p) if o.get("event") == "build")
              for p in seg_paths]
    per_q: dict = {}
    for (ws, key, q), occs in wins.items():
        per_q.setdefault(q, {}).setdefault((key, ws), []).extend(
            v for v, _seg in occs)
    sched = sched_fn(total_batches, args.batch_rows, args.pace)
    specs = {s["qid"]: s for s in sched}
    failures, silent, missing_backfill = [], [], []
    backfilled = 0
    for q, spec in specs.items():
        got = per_q.get(q)
        if not got:
            silent.append(q)
            continue
        want_all = oracle.get(q, {})
        min_ws = min(ws for (_k, ws) in got)
        max_ws = max(ws for (_k, ws) in got)
        leave = spec.get("leave")
        if leave is None:
            want = {kw: v for kw, v in want_all.items() if kw[1] >= min_ws}
        else:
            want = {kw: v for kw, v in want_all.items()
                    if min_ws <= kw[1] <= max_ws}
            if max_ws > leave + spec["L"]:
                failures.append((q, "emitted past its leave", max_ws, leave))
        incoherent = [kw for kw, vs in got.items()
                      if any(v != vs[0] for v in vs[1:])]
        if incoherent:
            failures.append((q, "inconsistent duplicate emissions",
                             incoherent[:2], None))
        flat = {kw: vs[0] for kw, vs in got.items()}
        if flat != want:
            failures.append((q, "diverged from oracle", {
                "missing": sorted(set(want) - set(flat))[:2],
                "extra": sorted(set(flat) - set(want))[:2],
                "value_diff": [kw for kw in set(flat) & set(want)
                               if flat[kw] != want[kw]][:2],
            }, None))
        join = spec.get("join")
        if join is not None:
            if min_ws < join:
                backfilled += 1
            elif S.qd_class_continuous(specs, q):
                missing_backfill.append(q)
    return {
        "oracle_rc": rc,
        "oracle_windows": sum(len(v) for v in oracle.values()),
        "queries": len(specs),
        "joined_live": sum(1 for s in sched if "join" in s),
        "departed": sum(1 for s in sched if "leave" in s),
        "pipeline_builds_per_segment": builds,
        "max_builds_per_segment": max(builds, default=0),
        "queries_silent": silent,
        "backfilled_joiners": backfilled,
        "backfill_missing": missing_backfill,
        "failures": len(failures),
        "failure_sample": failures[:3],
    }


class _Scan:
    """The whole lines a growing file gained since the last call."""

    def __init__(self, path):
        self.path = path
        self._pos = 0

    def lines(self) -> list[bytes]:
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            return []
        with f:
            f.seek(self._pos)
            data = f.read()
        end = data.rfind(b"\n") + 1
        self._pos += end
        return data[:end].splitlines()


class _Watch:
    """A running segment's files: its ready line (wall time, RSS), the
    wall time at which its first window line was seen and, with
    ``eof=True``, whether its source has read the feed's end (the scan of
    the window lines then goes on past the first)."""

    def __init__(self, out_path, side_path, eof=False):
        self._side = _Scan(side_path)
        self._out = _Scan(out_path)
        self._want_eof = eof
        self.ready: dict | None = None
        self.first_emit_wall: float | None = None
        self.eof = False

    def poll(self) -> None:
        if self.ready is None:
            for line in self._side.lines():
                if b'"ready"' in line:
                    self.ready = json.loads(line)
                    break
        if self.first_emit_wall is None or (self._want_eof and not self.eof):
            lines = self._out.lines()
            if self.first_emit_wall is None and any(
                    b'"ws"' in line for line in lines):
                self.first_emit_wall = time.time()
            self.eof = self.eof or any(b'"eof"' in line for line in lines)

    def kill_due(self, kill_every: float) -> bool:
        """The kill clock starts at the ready line, not at the spawn: on
        the card a child spends 6-11 s importing and starting CUDA, and a
        kill in that time cuts nothing the restore must rebuild."""
        return (self.ready is not None
                and time.time() >= self.ready["t"] + kill_every)


def _json_lines(path):
    """Every whole JSON line of ``path`` (a torn tail line is skipped)."""
    try:
        f = open(path)
    except FileNotFoundError:
        return
    with f:
        for line in f:
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def _slope(points) -> float | None:
    """Least-squares slope of (t, value) points, a unit a second."""
    if len(points) < 2:
        return None
    t = np.array([p[0] for p in points], dtype=np.float64)
    v = np.array([p[1] for p in points], dtype=np.float64)
    if np.ptp(t) <= 0:
        return None
    return float(np.polyfit(t - t[0], v, 1)[0])


def segment_device_report(path, first_emit_wall, rss_samples) -> dict:
    """A segment's start-up split, device memory, RSS and launches from
    its ``ready`` and ``device`` lines and the parent's RSS samples
    (``(wall, kB)``, taken after the first emission)."""
    ready, recs = {}, []
    for o in _json_lines(path):
        if o.get("event") == "ready":
            ready = o
        elif o.get("event") == "device":
            recs.append(o)
    rep: dict = {
        "device_name": ready.get("device_name"),
        "startup": {k: ready.get(k) for k in
                    ("imports_s", "cuda_ready_s", "kernels_loaded_s")},
        "launches": dict(recs[-1]["launches"]) if recs else {},
        "device_samples": len(recs),
    }

    def mem(r):
        return None if r is None else {
            k: r.get(k) for k in ("alloc", "reserved", "max_alloc")}

    fe = first_emit_wall
    at_fe = (next((r for r in recs if r["t"] >= fe), None)
             if fe is not None else None)
    with_alloc = [r for r in recs if r.get("alloc") is not None]
    rep["device_mem"] = {
        "at_first_emit": mem(at_fe),
        "max": ({"alloc": max(r["alloc"] for r in with_alloc),
                 "reserved": max(r["reserved"] for r in with_alloc),
                 "max_alloc": max(r["max_alloc"] for r in with_alloc)}
                if with_alloc else None),
        "end": mem(recs[-1]) if recs else None,
        "alloc_slope_bytes_per_s": (
            _slope([(r["t"], r["alloc"]) for r in with_alloc
                    if r["t"] >= fe + MEM_REF_AT_S])
            if fe is not None else None),
    }
    rss = [kb for _t, kb in rss_samples]
    rep["rss_kb"] = {
        "at_first_emit": rss[0] if rss else None,
        "max": max(rss) if rss else None,
        "end": rss[-1] if rss else None,
        "slope_kb_per_s": (
            _slope([p for p in rss_samples if p[0] >= fe + MEM_REF_AT_S])
            if fe is not None else None),
    }
    gate = {"applies": False}
    if fe is not None and with_alloc:
        ran = with_alloc[-1]["t"] - fe
        gate["ran_past_first_emit_s"] = round(ran, 1)
        ref = next((r for r in with_alloc if r["t"] >= fe + MEM_REF_AT_S),
                   None)
        if ran >= MEM_MIN_RUN_S and ref is not None:
            tail = [r["alloc"] for r in with_alloc
                    if r["t"] >= with_alloc[-1]["t"] - MEM_TAIL_S]
            bound = MEM_REL * ref["alloc"] + MEM_ABS_BYTES
            gate.update(
                applies=True, ref_alloc=ref["alloc"], tail_min=min(tail),
                tail_max=max(tail), bound_bytes=int(bound),
                ok=all(abs(a - ref["alloc"]) <= bound for a in tail),
            )
    rep["mem_gate"] = gate
    return rep


def device_gates(segments) -> dict:
    """The memory gate over every segment it applies to, and the launch
    gate: each restored segment launches exactly the hand kernels the
    first segment launched."""
    mem = [dict(segment=s["segment"], **s["mem_gate"]) for s in segments
           if s["mem_gate"].get("applies")]

    def launched(s):
        return sorted(k for k, n in s["launches"].items() if n > 0)

    first = launched(segments[0]) if segments else []
    per_seg = [{"segment": s["segment"], "launched": launched(s)}
               for s in segments]
    wrong = [p for p in per_seg[1:] if p["launched"] != first]
    return {
        "memory": {
            "bound": f"|alloc - ref| <= {MEM_REL:.0%} of ref + "
                     f"{MEM_ABS_BYTES >> 20} MiB over the last "
                     f"{MEM_TAIL_S:.0f} s, ref = alloc {MEM_REF_AT_S:.0f} s "
                     f"after the first emission, segments that ran "
                     f">= {MEM_MIN_RUN_S:.0f} s past it",
            "reason": MEM_BOUND_REASON,
            "segments_gated": len(mem),
            "segments": mem,
            "ok": all(m["ok"] for m in mem),
        },
        "launches": {
            "first_segment": first,
            "per_segment": per_seg,
            "restored_differing": [p["segment"] for p in wrong],
            "ok": bool(segments) and not wrong,
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--no-build", action="store_true",
                    help="skip the build before the first segment (the "
                    "caller built the kernels and host libraries)")
    ap.add_argument("--minutes", type=float, default=12.0)
    ap.add_argument("--pace", type=float, default=200_000.0)
    ap.add_argument("--batch-rows", type=int, default=4096)
    ap.add_argument("--kill-every", type=float, default=90.0)
    ap.add_argument("--pipeline", choices=PIPELINES, default="simple")
    ap.add_argument("--device", default="cuda",
                    help="the child's EngineConfig.device (cuda by default; "
                    "cpu for the tests)")
    ap.add_argument("--chaos", action="store_true",
                    help="arm tools/soak.py's seeded FaultPlan (broker "
                    "flaps, a worker crash, torn state writes, commit "
                    "hiccups) on the kafka pipeline; implies --pipeline "
                    "kafka")
    ap.add_argument("--chaos-seed", type=int, default=1234)
    ap.add_argument("--torch-threads", type=int, default=0,
                    help="torch.set_num_threads in every child (0: torch's "
                    "default, one a core; the CPU tests pass 1, as several "
                    "soaks share a host)")
    ap.add_argument("--keys", type=int, default=10_000_000,
                    help="bigstate: simultaneously-open sessions")
    ap.add_argument("--wave-keys", type=int, default=100_000,
                    help="bigstate: sessions closed per watermark wave")
    ap.add_argument("--state-budget", type=int, default=0,
                    help="bigstate: budget bytes (0 = working set / 5)")
    ap.add_argument("--ckpt-s", type=float, default=20.0,
                    help="bigstate: checkpoint interval")
    ap.add_argument("--max-kills", type=int, default=2,
                    help="bigstate: SIGKILLs issued mid-run")
    ap.add_argument("--chaos-spill", action="store_true", default=True,
                    help="bigstate: arm tools/soak.py's spill-site fault "
                    "plan (reload flaps, an eviction-write failure, a torn "
                    "manifest; default on)")
    ap.add_argument("--no-chaos-spill", dest="chaos_spill",
                    action="store_false")
    ap.add_argument("--cluster-workers", type=int, default=3,
                    help="cluster: worker processes")
    ap.add_argument("--cluster-partitions", type=int, default=6,
                    help="cluster: source partitions (static assignment)")
    ap.add_argument("--partial", action="store_true",
                    help="cluster: run only the partial-recovery cell "
                    "(default: the full-restart cell, then the partial)")
    ap.add_argument("--out", default=None,
                    help="the JSON report (default torch_soak_<pipeline>.json "
                    "in the working directory)")
    args = ap.parse_args()
    if args.child:
        child_main()
        return
    if args.build:
        build_main()
        return
    if args.chaos:
        if args.pipeline not in ("simple", "kafka"):
            ap.error("--chaos runs on the kafka pipeline only")
        args.pipeline = "kafka"
    if args.out is None:
        name = "chaos" if args.chaos else args.pipeline
        args.out = f"torch_soak_{name}.json"
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    run = {"bigstate": run_bigstate, "cluster": run_cluster_soak}.get(
        args.pipeline, run_parent)
    sys.exit(0 if run(args) else 1)


def build_kernels(args, report: dict, log) -> bool:
    """The ``--build`` subprocess, before the first segment on a card
    (skipped with ``--no-build``) → False, the report marked, if it
    failed."""
    if not args.device.startswith("cuda") or args.no_build:
        return True
    t_build = time.monotonic()
    rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                          "--build"], stdout=sys.stderr, stderr=sys.stderr)
    report["build_s"] = round(time.monotonic() - t_build, 1)
    if rc != 0:
        report.update(aborted=f"kernel build rc={rc}", ok=False)
        log(f"kernel build failed (rc={rc})")
        return False
    return True


def run_parent(args) -> bool:
    import shutil
    import tempfile

    total_batches = int(args.minutes * 60 * args.pace / args.batch_rows)
    work = tempfile.mkdtemp(prefix="torch_soak_")
    ckpt_dir = os.path.join(work, "ckpt")
    os.makedirs(ckpt_dir)
    if "SOAK_T0" not in os.environ:
        S.T0 = int(time.time()) * 1000 // S.WINDOW_MS * S.WINDOW_MS
    report: dict = {
        "pipeline": args.pipeline,
        "device": args.device,
        "minutes": args.minutes,
        "pace_rows_per_s": args.pace,
        "batch_rows": args.batch_rows,
        "total_rows": total_batches * args.batch_rows,
        "kill_every_s": args.kill_every,
        "segments": [],
    }

    def write(extra=None):
        report.update(extra or {})
        Path(args.out).write_text(json.dumps(report, indent=1))

    def log(msg):
        print(f"torch_soak: {msg}", file=sys.stderr, flush=True)

    env = dict(os.environ)
    env.update({
        "SOAK_BATCH_ROWS": str(args.batch_rows),
        "SOAK_PACE": str(args.pace),
        "SOAK_TOTAL_BATCHES": str(total_batches),
        "SOAK_CKPT_DIR": ckpt_dir,
        "SOAK_PIPELINE": args.pipeline,
        "SOAK_DEVICE": args.device,
        "SOAK_TORCH_THREADS": str(args.torch_threads),
    })
    if not build_kernels(args, report, log):
        write()
        return False
    chaos_spec = chaos_deterministic = None
    if args.chaos:
        chaos_spec = S.chaos_plan(args.chaos_seed)
        seq_a, seq_b = (chaos_sim_sequence(chaos_spec),
                        chaos_sim_sequence(chaos_spec))
        chaos_deterministic = bool(seq_a and seq_a == seq_b)
        report["chaos"] = {
            "seed": args.chaos_seed, "plan": chaos_spec,
            "fault_plan_deterministic": chaos_deterministic,
            "sim_injections": len(seq_a),
        }
        env["DENORMALIZED_FAULT_PLAN"] = json.dumps(chaos_spec)
        env["DENORMALIZED_LSM_PY"] = "1"
    broker = last_close_ws = None
    feed_anchor: dict = {}
    if args.pipeline == "kafka":
        broker, last_close_ws, feed_anchor = kafka_prep_and_feed(
            args, total_batches, log)
        env["SOAK_BOOTSTRAP"] = broker.bootstrap
        env["SOAK_LAST_CLOSE_WS"] = str(last_close_ws)
        # the first segment starts just before the feed does, so it reads
        # rows before its kill (its launches are the launch gate's base)
        time.sleep(max(0.0, S.T0 / 1000.0 - KAFKA_SPAWN_LEAD_S - time.time()))
    env["SOAK_T0"] = str(S.T0)  # after kafka's re-anchoring

    fold = {
        "join": lambda agg, i, br, pc: S.golden_update_join(
            agg, i, br, pc, total_batches),
        "session": S.golden_update_session,
        "sliding": S.golden_update_sliding,
        "approx": S.golden_update_approx,
        "query_dense": lambda agg, i, br, pc: None,
        "join_dense": lambda agg, i, br, pc: None,
    }.get(args.pipeline, S.golden_update)  # udaf: the tumbling fold
    golden: dict = {}
    golden_i = 0
    seg_paths, obs_paths = [], []
    seg = kills = 0
    t_start = time.monotonic()
    aborted = None
    recovery_times = []
    done = False
    proc = None
    feed_t0 = None  # wall time of the first segment's ready line
    feed_s = total_batches * args.batch_rows / args.pace
    try:
        while not done:
            seg += 1
            out_path = os.path.join(work, f"emit_{seg}.jsonl")
            obs_path = os.path.join(work, f"obs_{seg}.jsonl")
            seg_paths.append(out_path)
            obs_paths.append(obs_path)
            t_spawn = time.monotonic()
            seg_env = dict(env, SOAK_OUT=out_path, SOAK_OBS_OUT=obs_path,
                           SOAK_SPAWN_T=repr(time.time()))
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child"],
                env=seg_env, stdout=sys.stderr, stderr=sys.stderr)
            first_emit = first_emit_wall = None
            rss = []  # (wall, kB), only after the first emission
            watch = _Watch(out_path, out_path, eof=True)
            while True:
                rc = proc.poll()
                if rc is not None:
                    if rc != 0:
                        aborted = f"segment {seg} child rc={rc}"
                    done = True
                    break
                now = time.monotonic()
                if first_emit is not None and (r := S.rss_kb(proc.pid)):
                    rss.append((time.time(), r))
                watch.poll()
                if first_emit is None and watch.first_emit_wall is not None:
                    first_emit = now - t_spawn
                    first_emit_wall = watch.first_emit_wall
                    if seg > 1:
                        recovery_times.append(round(first_emit, 2))
                target_i = min(total_batches, int(
                    (now - t_start) * args.pace / args.batch_rows) + 200)
                while golden_i < target_i:
                    fold(golden, golden_i, args.batch_rows, args.pace)
                    golden_i += 1
                if feed_t0 is None and watch.ready is not None:
                    feed_t0 = watch.ready["t"]
                # never kill the final drain: once the child has read its
                # feed's end, or the feed's length has passed since the
                # first child was ready (Kafka's feed runs on the wall
                # clock from its own origin)
                final_drain = (
                    golden_i >= total_batches if args.pipeline == "kafka"
                    else watch.eof or (feed_t0 is not None
                                       and time.time() >= feed_t0 + feed_s))
                if not final_drain and watch.kill_due(args.kill_every):
                    os.kill(proc.pid, signal.SIGKILL)
                    kills += 1
                    proc.wait(10)
                    break
                time.sleep(0.5)
            dev = segment_device_report(out_path, first_emit_wall, rss)
            report["segments"].append({
                "segment": seg,
                "wall_s": round(time.monotonic() - t_spawn, 1),
                "first_emit_s": round(first_emit, 2) if first_emit else None,
                **dev,
            })
            s = report["segments"][-1]
            log(f"segment {seg}: {s['wall_s']} s, first emission "
                f"{s['first_emit_s']} s, start-up {s['startup']}, launches "
                f"{s['launches']}, device memory {s['device_mem']}, RSS kB "
                f"{s['rss_kb']}")
            write()
            if aborted:
                break
        while golden_i < total_batches and not aborted:
            fold(golden, golden_i, args.batch_rows, args.pace)
            golden_i += 1
        wins, dupes, done_seen, child_metrics, clipped = S.read_emissions(
            seg_paths)
        foreign = sorted({m for p in seg_paths for o in _json_lines(p)
                          if o.get("event") == "done"
                          for m in o.get("foreign_modules", [])})
        gates = device_gates(report["segments"])
        common = {
            "aborted": aborted,
            "eos_done_seen": done_seen,
            "kills": kills,
            "recovery_first_emit_s": recovery_times,
            "duplicate_emissions": dupes,
            "uncommitted_clipped": clipped,
            "child_metrics": child_metrics,
            "child_foreign_modules": foreign,
            "device_gates": gates,
            "rows_per_s": round(total_batches * args.batch_rows
                                / (time.monotonic() - t_start), 1),
        }
        base_ok = bool(
            not aborted and done_seen and kills >= 1
            and all(t < RECOVERY_LIMIT_S for t in recovery_times)
            and not foreign and gates["memory"]["ok"]
            and gates["launches"]["ok"])
        try:
            telemetry = derive_telemetry(
                obs_paths, anchor_epoch_ms=(feed_anchor["epoch"] * 1000.0
                                            if feed_anchor else None))
        except Exception as e:  # dnzlint: allow(broad-except) telemetry is reporting, not verification
            telemetry = {"error": str(e)}
        if args.pipeline in ("query_dense", "join_dense"):
            dense_join = args.pipeline == "join_dense"
            qd = None if aborted else dense_verify(
                args, env, work, wins, seg_paths, total_batches,
                sched_fn=S.jd_schedule if dense_join else S.qd_schedule,
                oracle_pipeline=f"{args.pipeline}_oracle")
            ok = bool(
                base_ok and kills >= 2 and qd is not None
                and qd["oracle_rc"] == 0 and qd["oracle_windows"] > 0
                and qd["failures"] == 0 and not qd["queries_silent"]
                and not qd["backfill_missing"]
                and qd["backfilled_joiners"] >= (3 if dense_join else 10)
                and qd["max_builds_per_segment"] == 1)
            write({**common, "telemetry": telemetry,
                   "emitted_rows": sum(len(v) for v in wins.values()),
                   args.pipeline: qd, "ok": ok})
            print(json.dumps({"ok": ok, "pipeline": args.pipeline,
                              "kills": kills, "failures": qd and qd["failures"],
                              "aborted": aborted}))
            return ok
        if args.pipeline == "kafka" and not aborted:
            # windows past the last closable one may or may not close
            # before the child exits: clip both sides to it
            golden = {k: g for k, g in golden.items()
                      if k[0] <= last_close_ws}
            wins = {k: v for k, v in wins.items() if k[0] <= last_close_ws}
        if args.pipeline == "session" and not aborted:
            # emissions key on the session start (min ts in the burst)
            golden = {(int(g[4]), k[1]): g for k, g in golden.items()}
        lost, spurious, mismatched = [], [], []
        if not aborted:
            for k, g in golden.items():
                occs = wins.get(k)
                if not occs:
                    lost.append(k)
                    continue
                want = _golden_row(args.pipeline, k, g)
                for got, seg_idx in occs:  # every occurrence, dupes too
                    if len(got) != len(want) or any(
                            abs(a - b) > 1e-3 for a, b in zip(got, want)):
                        mismatched.append((k, got, want,
                                           {"segment": seg_idx}))
            spurious = [k for k in wins if k not in golden]
        chaos_ok = True
        if args.chaos:
            chaos_report = _chaos_report(seg_paths)
            report["chaos"].update(chaos_report)
            chaos_ok = bool(chaos_deterministic and len(
                chaos_report["required_rules_fired"])
                == len(S.CHAOS_REQUIRED_RULES))
        ok = bool(base_ok and not lost and not spurious and not mismatched
                  and len(wins) == len(golden) > 0 and chaos_ok)
        write({**common, "telemetry": telemetry,
               "golden_windows": len(golden), "emitted_windows": len(wins),
               "windows_lost": len(lost),
               "windows_spurious": len(spurious),
               "windows_mismatched": len(mismatched),
               "mismatch_sample": mismatched[:3],
               "spurious_sample": spurious[:3], "ok": ok})
        print(json.dumps({
            "ok": ok, "pipeline": args.pipeline, "kills": kills,
            "windows": len(wins), "lost": len(lost), "dupes": dupes,
            "aborted": aborted,
            "memory_gate": gates["memory"]["ok"],
            "launch_gate": gates["launches"]["ok"],
        }))
        return ok
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        if broker is not None:
            broker.stop()
        shutil.rmtree(work, ignore_errors=True)


#: bigstate's RSS gates.  The saving, ``tools/soak.py``'s: the budgeted
#: run's peak RSS at least 35% of the reference's working set below the
#: reference's.  The ratio, unlike ``tools/soak.py``'s, divides the RSS
#: above each segment's ready line (after the imports, the CUDA context
#: and the kernel libraries, before the first batch: the same point in
#: both runs), as whole-process peaks count a process's fixed part as if it
#: were state: at ``--keys 200000 --wave-keys 20000`` the JAX package's own
#: run on the CPU read 224,312 / 237,152 kB = 0.946 from a 26.1 MB working
#: set, and a child on the card holds ~4.9 GB before its first batch,
#: which would pull even the 10M-key run's 3,409,628 / 4,018,484 kB to
#: about 0.93.
BIGSTATE_RSS_RATIO_MAX = 0.9
BIGSTATE_RSS_SAVED_SHARE = 0.35
#: evictable resident state may exceed the budget by the estimate's gap
#: and the batch being folded (``tools/soak.py``'s slack)
BIGSTATE_EVICTABLE_SLACK = 1.25
#: a kill due ``--kill-every`` s after the ready line waits for a ``state``
#: line with a committed epoch and spilled bytes, at most this long: on a
#: loaded host the first 2 s checkpoint and the first spill can both come
#: after the smoke's 5 s, and a cut before them proves nothing of a restore
#: mid-spill
BIGSTATE_CUT_WAIT_S = 30.0


def bigstate_cut(side_path, t_cut: float, ready: dict | None) -> dict:
    """A kill's cut from its segment's ``state`` lines: the last one
    written before the SIGKILL (committed epoch, spilled keys, bytes and
    blocks, live keys)."""
    last = None
    for o in _json_lines(side_path):
        if o.get("event") == "state" and o.get("t", 0) <= t_cut:
            last = o
    cut = {"t": round(t_cut, 3),
           "after_ready_s": (round(t_cut - ready["t"], 2)
                             if ready else None)}
    for k in ("committed_epoch", "spilled_keys", "spilled_bytes",
              "spilled_blocks", "live_keys", "bytes", "evictable"):
        cut[k] = last.get(k) if last else None
    cut["state_line_age_s"] = round(t_cut - last["t"], 2) if last else None
    return cut


#: the owner split's fields a segment's report keeps, from the ``mem``
#: record of its ``state`` line nearest its RSS peak
BIGSTATE_OWNER_FIELDS = (
    "rss_kb", "anon_kb", "private_dirty_kb", "arena_kb", "in_use_kb",
    "free_held_kb", "mmap_kb", "table_bytes", "interner_keys",
    "interner_est_bytes", "lsm_keys", "ckpt_doc_bytes")


def bigstate_owners(side_path, ready: dict | None, t_peak: float | None
                    ) -> dict | None:
    """Where a segment's RSS went: the owner split at its ready line and
    in the ``state`` line nearest its peak RSS sample (``t_peak``), each
    field's growth above the ready line, and the state line's live and
    spilled keys → None without a ready line or a state line."""
    if ready is None or t_peak is None or "mem" not in ready:
        return None
    near = None
    for o in _json_lines(side_path):
        if o.get("event") == "state" and "mem" in o and (
                near is None
                or abs(o["t"] - t_peak) < abs(near["t"] - t_peak)):
            near = o
    if near is None:
        return None
    base, mem = ready["mem"], near["mem"]
    return {
        "peak_after_ready_s": round(t_peak - ready["t"], 2),
        "line_after_ready_s": round(near["t"] - ready["t"], 2),
        "live_keys": near.get("live_keys"),
        "spilled_keys": near.get("spilled_keys"),
        "at_line": {k: mem.get(k) for k in BIGSTATE_OWNER_FIELDS},
        "above_ready_kb": {k: mem[k] - base[k] for k in base
                           if isinstance(mem.get(k), int)},
    }


def bigstate_rss(segments) -> dict:
    """A run's RSS: the whole process's peak (``raw``), and the peak above
    each segment's own ready-line RSS (``net``)."""
    raw = [s["rss_max_kb"] for s in segments if s["rss_max_kb"]]
    net = [s["rss_net_max_kb"] for s in segments
           if s["rss_net_max_kb"] is not None]
    return {"raw_max_kb": max(raw, default=None),
            "net_max_kb": max(net, default=None),
            "ready_kb": [s["rss_ready_kb"] for s in segments]}


def bigstate_gates(*, keys, waves, ref, bud, working_set, budget,
                   chaos_spill) -> dict:
    """Every gate of the bigstate soak → {gate: bool}.  ``ref`` and
    ``bud`` are the two runs' summaries (sessions, cuts, states, RSS)."""
    ref_rss, bud_rss = ref["rss"], bud["rss"]
    saved = ((ref_rss["raw_max_kb"] - bud_rss["raw_max_kb"]) * 1024
             if ref_rss["raw_max_kb"] and bud_rss["raw_max_kb"] else None)
    net_ratio = (bud_rss["net_max_kb"] / ref_rss["net_max_kb"]
                 if ref_rss["net_max_kb"] and bud_rss["net_max_kb"]
                 is not None else None)
    return {
        "not_aborted": not ref["aborted"] and not bud["aborted"],
        "eos_both_runs": ref["done"] and bud["done"],
        "sessions_expected": ref["sessions"] == keys
        + waves * BIGSTATE_WAVE_ROWS,
        "none_lost_spurious_mismatched": not (
            bud["lost"] or bud["spurious"] or bud["mismatched"]),
        "kills": len(bud["cuts"]) >= 1,
        "kill_after_commit_with_spill": any(
            c["committed_epoch"] and (c["spilled_bytes"] or 0) > 0
            for c in bud["cuts"]),
        "spilled": bud["spill"].get("spill_blocks_total", 0) > 0,
        "evictable_within_budget": bud["evictable_max"]
        <= BIGSTATE_EVICTABLE_SLACK * budget,
        "rss_saved": saved is not None
        and saved >= BIGSTATE_RSS_SAVED_SHARE * working_set,
        "rss_net_ratio": net_ratio is not None
        and net_ratio <= BIGSTATE_RSS_RATIO_MAX,
        "fault_rules_fired": not chaos_spill or all(
            r in bud["fired_rules"] for r in S.BIGSTATE_REQUIRED_RULES),
    }


def run_bigstate(args) -> bool:
    """``tools/soak.py::bigstate_main`` on the port: an unbudgeted
    reference run over ``--keys`` simultaneously-open sessions, then the
    same feed under a state budget (``--state-budget``, by default a fifth
    of the reference's working set) with the cold tier and checkpoints on,
    the spill-site fault plan armed and ``--max-kills`` SIGKILLs, each
    ``--kill-every`` s after its segment's ready line and once its last
    ``state`` line shows a committed epoch with spilled state (at most
    ``BIGSTATE_CUT_WAIT_S`` later).  Gates
    (``bigstate_gates``): ``tools/soak.py``'s, its RSS ratio taken net of
    each segment's ready-line RSS, a kill after a committed epoch with
    spilled state at the cut, no module of JAX in a child, and both device
    gates over every segment of both runs."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="torch_soak_bs_")
    a_batches = -(-args.keys // args.batch_rows)
    waves = -(-args.keys // args.wave_keys)
    report: dict = {
        "pipeline": "bigstate", "device": args.device, "keys": args.keys,
        "wave_keys": args.wave_keys, "batch_rows": args.batch_rows,
        "kill_every_s": args.kill_every, "ckpt_s": args.ckpt_s,
        "max_kills": args.max_kills, "phaseA_batches": a_batches,
        "close_waves": waves, "segments": [],
    }

    def write():
        Path(args.out).write_text(json.dumps(report, indent=1))

    def log(msg):
        print(f"torch_soak: {msg}", file=sys.stderr, flush=True)

    env = dict(os.environ)
    env.update({
        "SOAK_BATCH_ROWS": str(args.batch_rows),
        "SOAK_PACE": str(args.pace),
        "SOAK_TOTAL_BATCHES": str(a_batches + waves),
        "SOAK_PIPELINE": "bigstate",
        "SOAK_BS_KEYS": str(args.keys),
        "SOAK_BS_WAVE": str(args.wave_keys),
        "SOAK_T0": str(S.T0),
        "SOAK_CKPT_S": str(args.ckpt_s),
        "SOAK_DEVICE": args.device,
        "SOAK_TORCH_THREADS": str(args.torch_threads),
    })
    if not build_kernels(args, report, log):
        write()
        return False

    def run(tag: str, budget: int, max_kills: int) -> dict:
        ckpt = os.path.join(work, f"ckpt_{tag}")
        os.makedirs(ckpt)
        renv = dict(env, SOAK_BS_BUDGET=str(budget), SOAK_CKPT_DIR=ckpt)
        if budget and args.chaos_spill:
            renv["DENORMALIZED_FAULT_PLAN"] = json.dumps(
                S.bigstate_fault_plan(args.chaos_seed))
        paths, cuts, aborted = [], [], None
        t0 = time.monotonic()
        while True:
            path = os.path.join(work, f"{tag}_{len(paths) + 1}.jsonl")
            side = path + ".state"
            paths.append(path)
            t_spawn, spawn_wall = time.monotonic(), time.time()
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child"],
                env=dict(renv, SOAK_OUT=path, SOAK_SPAWN_T=repr(spawn_wall)),
                stdout=sys.stderr, stderr=sys.stderr)
            watch = _Watch(path, side)
            states = _Scan(side)
            cut_ok = False  # the last state line: a commit, spilled bytes
            rss = []  # (wall, kB) from the spawn
            t_cut = None
            try:
                while proc.poll() is None:
                    if r := S.rss_kb(proc.pid):
                        rss.append((time.time(), r))
                    watch.poll()
                    for line in states.lines():
                        if b'"state"' in line:
                            o = json.loads(line)
                            cut_ok = bool(o.get("committed_epoch")) and (
                                o.get("spilled_bytes") or 0) > 0
                    if len(cuts) < max_kills and watch.kill_due(
                            args.kill_every) and (cut_ok or watch.kill_due(
                                args.kill_every + BIGSTATE_CUT_WAIT_S)):
                        t_cut = time.time()
                        os.kill(proc.pid, signal.SIGKILL)
                        proc.wait(10)
                        break
                    time.sleep(0.5)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10)
            watch.poll()
            fe = watch.first_emit_wall
            ready = watch.ready
            after_ready = [kb for t, kb in rss if ready and t >= ready["t"]]
            ready_kb = ready.get("rss_kb") if ready else None
            seg = {
                "segment": len(report["segments"]) + 1, "run": tag,
                "wall_s": round(time.monotonic() - t_spawn, 1),
                "first_emit_s": round(fe - spawn_wall, 2) if fe else None,
                "killed": t_cut is not None,
                "rss_ready_kb": ready_kb,
                "rss_max_kb": max((kb for _t, kb in rss), default=None),
                "rss_net_max_kb": (max(after_ready) - ready_kb
                                   if after_ready and ready_kb else None),
                "owners": bigstate_owners(side, ready, max(
                    ((kb, t) for t, kb in rss if ready and t >= ready["t"]),
                    default=(None, None))[1]),
                **segment_device_report(
                    side, fe, [p for p in rss if fe and p[0] >= fe]),
            }
            report["segments"].append(seg)
            log(f"bigstate {tag} segment {seg['segment']}: {seg['wall_s']} "
                f"s, killed {seg['killed']}, start-up {seg['startup']}, RSS "
                f"kB ready {ready_kb}, max {seg['rss_max_kb']}, launches "
                f"{seg['launches']}")
            if t_cut is not None:
                cuts.append(dict(segment=seg["segment"],
                                 **bigstate_cut(side, t_cut, ready)))
                log(f"bigstate {tag} cut: {cuts[-1]}")
                continue
            if proc.returncode != 0:
                aborted = f"{tag} segment {seg['segment']} child " \
                          f"rc={proc.returncode}"
            break
        sides = [p + ".state" for p in paths]
        states = S.read_state_events(sides)
        last_spill: dict = {}
        for st in states:
            if st.get("spill"):
                last_spill[st["_path"]] = st["spill"]
        spill: dict = {}
        for sp in last_spill.values():  # counters restart with each child
            for k, v in sp.items():
                if isinstance(v, (int, float)):
                    spill[k] = spill.get(k, 0) + v
        segs = [s for s in report["segments"] if s["run"] == tag]
        return {
            "wall_s": round(time.monotonic() - t0, 1), "paths": paths,
            "aborted": aborted, "cuts": cuts,
            # the reference's is the working set; the budgeted run's, its
            # resident state (the interned keys stay resident by design)
            "bytes_max": max((st.get("bytes") or 0 for st in states),
                             default=0),
            "evictable_max": max((st.get("evictable") or 0 for st in states),
                                 default=0),
            "spill": spill, "rss": bigstate_rss(segs),
            "fired_rules": _chaos_report(sides)["fired_rules"],
            "foreign_modules": sorted({
                m for p in sides for o in _json_lines(p)
                if o.get("event") == "done"
                for m in o.get("foreign_modules", [])}),
        }

    try:
        ref = run("reference", 0, 0)
        working_set = ref["bytes_max"]
        budget = args.state_budget or max(working_set // 5, 1_000_000)
        log(f"bigstate reference: {ref['wall_s']} s, working set "
            f"{working_set} B, budget {budget} B")
        bud = run("budgeted", budget, args.max_kills)
        wins_ref, ref_dupes, ref["done"], _m, _c = S.read_emissions(
            ref["paths"])
        wins_b, dupes, bud["done"], _m, clipped = S.read_emissions(
            bud["paths"])
        # every budgeted occurrence, re-emissions after a restore too,
        # must equal the reference's
        lost = [k for k in wins_ref if k not in wins_b]
        spurious = [k for k in wins_b if k not in wins_ref]
        mismatched = 0
        mismatch_sample = []
        for k, occs in wins_ref.items():
            for vals, _seg in wins_b.get(k, ()):
                if vals != occs[0][0]:
                    mismatched += 1
                    if len(mismatch_sample) < 3:
                        mismatch_sample.append((k, vals, occs[0][0]))
        ref["sessions"], bud["sessions"] = len(wins_ref), len(wins_b)
        bud.update(lost=len(lost), spurious=len(spurious),
                   mismatched=mismatched)
        del wins_ref, wins_b
        gates = bigstate_gates(keys=args.keys, waves=waves, ref=ref, bud=bud,
                               working_set=working_set, budget=budget,
                               chaos_spill=args.chaos_spill)
        dev = device_gates(report["segments"])
        foreign = sorted(set(ref["foreign_modules"])
                         | set(bud["foreign_modules"]))
        gates.update(child_modules=not foreign,
                     device_memory=dev["memory"]["ok"],
                     device_launches=dev["launches"]["ok"])
        ref_rss, bud_rss = ref["rss"], bud["rss"]

        def ratio(a, b):
            return round(a / b, 4) if a is not None and b else None

        report.update({
            "reference": {"working_set_bytes": working_set, **{
                k: ref[k] for k in ("wall_s", "sessions", "rss")}},
            "budget_bytes": budget,
            "budget_ratio": round(working_set / budget, 2),
            "budgeted": {
                **{k: bud[k] for k in (
                    "wall_s", "sessions", "spill", "rss", "cuts")},
                "resident_state_bytes_max": bud["bytes_max"],
                "evictable_state_bytes_max": bud["evictable_max"],
                "kills": len(bud["cuts"]),
                "duplicate_emissions": dupes,
                "uncommitted_clipped": clipped,
            },
            "reference_duplicate_emissions": ref_dupes,
            "chaos_spill": {
                "armed": bool(args.chaos_spill),
                "fired_rules": bud["fired_rules"],
                "required_rules_fired": sorted(
                    r for r in S.BIGSTATE_REQUIRED_RULES
                    if r in bud["fired_rules"]),
            },
            "sessions_expected": args.keys + waves * BIGSTATE_WAVE_ROWS,
            "sessions_lost": len(lost),
            "sessions_spurious": len(spurious),
            "sessions_mismatched": mismatched,
            "mismatch_sample": mismatch_sample,
            "rss_ratio_raw": ratio(bud_rss["raw_max_kb"],
                                   ref_rss["raw_max_kb"]),
            "rss_ratio_net": ratio(bud_rss["net_max_kb"],
                                   ref_rss["net_max_kb"]),
            "rss_saved_mb": (round((ref_rss["raw_max_kb"]
                                    - bud_rss["raw_max_kb"]) / 1024, 1)
                             if ref_rss["raw_max_kb"]
                             and bud_rss["raw_max_kb"] else None),
            "rss_saved_required_mb": round(
                BIGSTATE_RSS_SAVED_SHARE * working_set / 2**20, 1),
            "child_foreign_modules": foreign,
            "device_gates": dev,
            "aborted": ref["aborted"] or bud["aborted"],
            "gates": gates,
            "ok": all(gates.values()),
        })
        write()
        print(json.dumps({
            "ok": report["ok"], "pipeline": "bigstate",
            "sessions": bud["sessions"], "kills": len(bud["cuts"]),
            "spill_blocks": bud["spill"].get("spill_blocks_total", 0),
            "rss_ratio_raw": report["rss_ratio_raw"],
            "rss_ratio_net": report["rss_ratio_net"],
            "failed_gates": sorted(k for k, v in gates.items() if not v),
        }))
        return report["ok"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- cluster ---------------------------------------------------------------

#: ``tools/soak.py::_cluster_cell``'s job: 97 string keys, batches of
#: min(--batch-rows, 1,024) rows spanning 250 ms, 1 s windows, a read every
#: 0.05 s a partition, barriers every second
CLUSTER_KEYS = 97
CLUSTER_PACE_S = 0.05
CLUSTER_CKPT_S = 1.0
#: the victim's SIGKILL lands at most this share of one partition's stream
#: after the last worker's ready line (the JAX cell's share)
CLUSTER_KILL_SHARE = 0.4


def cluster_job_args(args) -> dict:
    """The JAX cell's job arguments, the workers on ``--device``."""
    return {
        "partitions": args.cluster_partitions,
        "batches": max(20, int(args.minutes * 60 / CLUSTER_PACE_S / 2)),
        "rows": min(args.batch_rows, 1024),
        "keys": CLUSTER_KEYS,
        "batch_span_ms": 250,
        "window_ms": 1000,
        "pace_s": CLUSTER_PACE_S,
        "engine": {"device": args.device},
    }


def cluster_kill_delay(args, job_args: dict) -> float:
    """Seconds from the last worker's ready line to the victim's SIGKILL:
    ``--kill-every``, capped at 40% of one partition's stream (``batches x
    pace_s``).  A worker reads its partitions one after another, so this
    lands before 40% of its own stream too.  The JAX cell kills
    ``min(kill_every, 0.4 x per-worker wall)`` after the spawn
    (``tools/soak.py:2470-2475``), which on the card lands before the
    workers' 8-13 s start-up ends and so before the first commit; here the
    clock starts at the ready lines and the kill also waits for a commit."""
    partition_s = job_args["batches"] * job_args["pace_s"]
    return round(min(args.kill_every, CLUSTER_KILL_SHARE * partition_s), 3)


def cluster_fault_plan(args, partial: bool, victim: int) -> dict:
    """The JAX cell's one torn ``exchange.send`` frame: on worker 0's edges
    after 40 frames (full restart), on the victim's after 150 (partial:
    past the first commit)."""
    return {"seed": args.chaos_seed, "rules": [{
        "site": "exchange.send", "kind": "torn",
        "key_substr": f"{victim}->" if partial else "0->",
        "after": 150 if partial else 40, "times": 1,
        "name": "torn-exchange-frame",
    }]}


def cluster_soak_job(args: dict) -> dict:
    """``benchjob.soak_job`` in a worker that writes, when it exits, the
    modules of JAX or of the JAX package it holds to ``args["probe"]``
    .<pid> (a SIGKILLed incarnation writes none)."""
    import atexit

    from denormalized_tpu_torch.cluster import benchjob

    def probe():
        with open(f"{args['probe']}.{os.getpid()}", "w") as f:
            json.dump(_foreign_modules(), f)

    atexit.register(probe)
    return benchjob.soak_job(args)


def cluster_gates(cell: dict, *, partial: bool, victim: int, n: int,
                  device: str) -> dict:
    """Every gate of one cluster cell → {gate: bool}: the JAX cell's, a
    kill after a committed epoch, every worker's last generation on
    ``device`` (on a card, with dense launches), and no module of JAX in
    the workers that exited."""
    kind = device.split(":")[0]
    workers = cell["workers"]
    gates = {
        "done": cell["status"] == "done",
        "exactly_once": cell["lost"] == cell["spurious"]
        == cell["duplicate_emissions"] == 0,
        "killed": cell["sigkills"] >= 1,
        "torn_frame_fired": cell["exchange_faults_fired"] >= 1,
        "kill_after_commit": any(k["committed"] for k in cell["kills"]),
        "card": len(workers) == n and all(
            w["device"].split(":")[0] == kind
            and (kind != "cuda" or w["dense_window_launches"] > 0)
            for w in workers.values()),
        "worker_modules": cell["worker_probes"] >= n
        and not cell["worker_foreign_modules"],
    }
    if partial:
        segs = cell["partial_segments"]
        gates.update(
            no_full_restart=cell["restarts"] == 0,
            worker_restarted=cell["worker_restarts"] >= 1,
            partial_only_victim=bool(segs) and all(
                s["worker"] == victim for s in segs),
            partial_restored=bool(segs) and all(
                (s["restored"] or 0) >= 1 for s in segs),
            victim_recovered=any(r["worker"] == victim and r["ms"] > 0
                                 for r in cell["recoveries"]),
            recovery_histogram=cell["recovery_ms_histogram"].get(
                "count", 0) >= 1,
        )
    else:
        gates["restarts"] = cell["restarts"] >= 2
    return gates


def cluster_oracle(args) -> tuple[list, float]:
    """The uninterrupted single-process oracle of the cells' job on
    ``--device``, read unpaced (the pace only sleeps between reads) →
    (sorted canonical rows, seconds)."""
    from denormalized_tpu_torch.cluster import benchjob

    t0 = time.perf_counter()
    rows = benchjob.oracle_rows(dict(cluster_job_args(args), pace_s=0.0),
                                string_keys=True)
    return rows, time.perf_counter() - t0


def cluster_cell(args, partial: bool, oracle: list, log) -> dict:
    """One cell of ``tools/soak.py::_cluster_cell`` on the port: the paced
    job over ``--cluster-workers`` worker processes on ``--device``, one
    torn exchange frame and a SIGKILL of the last worker after a committed
    epoch, the clipped union of every segment held to the uninterrupted
    single-process oracle exactly once.  ``full_restart`` restarts the
    whole cluster at each failure (at least 2); ``partial`` respawns only
    the victim (``max_restarts=0``: a full restart fails the cell)."""
    import shutil
    import tempfile
    from collections import Counter

    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
    from denormalized_tpu_torch.cluster import benchjob
    from denormalized_tpu_torch.cluster.reader import read_cluster

    n = args.cluster_workers
    victim = n - 1
    mode = "partial" if partial else "full_restart"
    job_args = cluster_job_args(args)
    delay = cluster_kill_delay(args, job_args)
    work = tempfile.mkdtemp(prefix="torch_soak_cl_")
    job_args["probe"] = os.path.join(work, "probe")
    log(f"cluster [{mode}]: {n} workers, {job_args['partitions']} "
        f"partitions, {job_args['batches']} batches a partition, worker "
        f"{victim} SIGKILLed {delay} s after the last ready line, past a "
        f"commit")
    try:
        def recovery_hist() -> dict:
            return dict(obs.registry().snapshot().get(
                "dnz_cluster_recovery_ms") or {})

        count0 = recovery_hist().get("count", 0)
        spec = ClusterSpec(
            workdir=work, n_workers=n,
            job="tools.torch_soak:cluster_soak_job", job_args=job_args,
            sys_path=[str(REPO)], checkpoint_interval_s=CLUSTER_CKPT_S,
            sink="jsonl", max_restarts=0 if partial else 4,
            liveness_timeout_s=300.0, metrics_jsonl=True,
            fault_plan=cluster_fault_plan(args, partial, victim),
            partial_recovery=partial)
        t0 = time.perf_counter()
        try:
            result = run_cluster(spec, kill_plan=[{
                "worker": victim, "min_commits": 1,
                "after_ready_s": delay}])
        except Exception as e:  # a full restart past max_restarts
            result = {"status": f"raised {type(e).__name__}: {e}"}
        wall = time.perf_counter() - t0
        got = (read_cluster(result["segments"]) if "segments" in result
               else {"rows": [], "clipped": 0})
        counts = Counter(benchjob.canonical_row(r) for r in got["rows"])
        dupes = sum(c - 1 for c in counts.values() if c > 1)
        want = Counter(oracle)
        obs_dir = os.path.join(work, "obs")
        merged = _port_obs_readers().merge_final_snapshots(sorted(
            os.path.join(obs_dir, f) for f in os.listdir(obs_dir))
        ) if os.path.isdir(obs_dir) else {"series": {}}
        # a tear can kill its worker before the next metrics export: the
        # coordinator's crash log is the second evidence
        fired = max(int(sum(
            v for k, v in merged["series"].items()
            if k.startswith("dnz_fault_injections_total")
            and "exchange" in k and isinstance(v, (int, float)))),
            sum(1 for why in result.get("crashes", []) if "torn" in why))
        probes = [p for p in os.listdir(work) if p.startswith("probe.")]
        hist = recovery_hist()
        if hist:
            hist["count"] = hist.get("count", 0) - count0
        cell = {
            "mode": mode,
            "workers_n": n,
            "partitions": job_args["partitions"],
            "batches": job_args["batches"],
            "total_rows": job_args["partitions"] * job_args["batches"]
            * job_args["rows"],
            "kill_delay_s": delay,
            "oracle_windows": len(oracle),
            "emitted_windows_kept": sum(counts.values()),
            "clipped_uncommitted": got["clipped"],
            "lost": sum((want - counts).values()),
            "spurious": sum((counts - want).values()) - dupes,
            "duplicate_emissions": dupes,
            "status": result["status"],
            "sigkills": result.get("killed_workers", 0),
            "kills": result.get("kills", []),
            "exchange_faults_fired": fired,
            "restarts": result.get("restarts"),
            "worker_restarts": result.get("worker_restarts"),
            "commits": result.get("commits", []),
            "aborted_epochs": result.get("aborted_epochs", []),
            "recoveries": result.get("recoveries", []),
            "recovery_ms_histogram": hist,
            "crashes": result.get("crashes", []),
            "partial_segments": [
                {"worker": s["worker"], "restored": s.get("restored")}
                for s in result.get("segments", []) if s.get("partial")],
            "startups": result.get("startups", []),
            "workers": {w: {k: m.get(k) for k in (
                "device", "dense_window_launches", "merge_partials_launches",
                "compact_slot_launches", "scatter_steps", "rows_in", "rows")}
                for w, m in result.get("workers", {}).items()},
            "worker_probes": len(probes),
            "worker_foreign_modules": sorted({
                m for p in probes
                for m in json.loads(Path(work, p).read_text())}),
            "ingest_wall_s_max": result.get("ingest_wall_s_max"),
            "wall_s": round(wall, 3),
            "host_cores": os.cpu_count(),
        }
        cell["gates"] = cluster_gates(cell, partial=partial, victim=victim,
                                      n=n, device=args.device)
        cell["pass"] = all(cell["gates"].values())
        log(f"cluster [{mode}]: {cell['status']}, {cell['wall_s']} s, "
            f"windows {cell['emitted_windows_kept']} of "
            f"{cell['oracle_windows']}, lost {cell['lost']}, spurious "
            f"{cell['spurious']}, duplicates {dupes}, clipped "
            f"{cell['clipped_uncommitted']}; kills {cell['kills']}; restarts "
            f"{cell['restarts']}, worker restarts {cell['worker_restarts']}, "
            f"recoveries {cell['recoveries']}; commits "
            f"{len(cell['commits'])}, aborted {cell['aborted_epochs']}; "
            f"start-ups {[(s['worker'], s['s']) for s in cell['startups']]}"
            f"; workers {cell['workers']}; failed gates "
            f"{sorted(k for k, v in cell['gates'].items() if not v)}")
        return cell
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_cluster_soak(args) -> bool:
    """``tools/soak.py::cluster_main`` on the port: the ``full_restart``
    cell and the ``partial`` cell (``--partial``: the partial cell alone),
    one report; the oracle runs in this process, the workers are spawned
    processes on ``--device``.  This process imports ``torch`` and
    ``denormalized_tpu_torch`` only."""
    report: dict = {"pipeline": "cluster", "device": args.device,
                    "minutes": args.minutes, "cells": {}}

    def write():
        Path(args.out).write_text(json.dumps(report, indent=1))

    def log(msg):
        print(f"torch_soak: {msg}", file=sys.stderr, flush=True)

    import torch

    if args.torch_threads:
        # this process's oracle, and every worker it spawns
        torch.set_num_threads(args.torch_threads)
        os.environ["DENORMALIZED_WORKER_TORCH_THREADS"] = str(
            args.torch_threads)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        report.update(aborted="no CUDA device (torch.cuda.is_available() "
                      "is False)", ok=False)
        log(report["aborted"])
        write()
        return False
    if not build_kernels(args, report, log):
        write()
        return False
    report["card"] = (torch.cuda.get_device_name(0)
                      if args.device.startswith("cuda") else None)
    oracle, report["oracle_s"] = cluster_oracle(args)
    for partial in ([True] if args.partial else [False, True]):
        cell = cluster_cell(args, partial, oracle, log)
        report["cells"][cell["mode"]] = cell
        write()
    report["parent_foreign_modules"] = _foreign_modules()
    report["ok"] = all(c["pass"] for c in report["cells"].values()) \
        and not report["parent_foreign_modules"]
    write()
    print(json.dumps({
        "ok": report["ok"], "pipeline": "cluster",
        **{mode: {"wall_s": c["wall_s"], "windows": c["emitted_windows_kept"],
                  "failed_gates": sorted(
                      k for k, v in c["gates"].items() if not v)}
           for mode, c in report["cells"].items()}}))
    return report["ok"]


def _golden_row(pipeline, k, g) -> tuple:
    """The golden's (window, key) cell as the child's rounded record."""
    if pipeline == "join":
        cnt, sm = g
        return (cnt, round(sm / cnt, 4),
                S.dim_value(int(k[1].rsplit("_", 1)[1]),
                            k[0] // 1000 - S.T0 // 1000))
    if pipeline == "session":
        cnt, mn, mx, sm, t0, t1 = g
        return (cnt, round(mn, 4), round(mx, 4), round(sm / cnt, 4), t0,
                t1 + S.SESSION_GAP_MS)
    if pipeline == "udaf":
        cnt, mn, mx, _sm = g
        return (cnt, round(mx - mn, 4))
    if pipeline == "approx":
        # exact integer equality with the JAX package's sketch kernels
        cnt, plane = g
        return (cnt, int(S._sk().hll_estimate(plane)[0]))
    cnt, mn, mx, sm = g
    return (cnt, round(mn, 4), round(mx, 4), round(sm / cnt, 4))


def _chaos_report(seg_paths) -> dict:
    events = S.read_chaos_events(seg_paths)
    rules: dict = {}
    sites: dict = {}
    for ev in events:
        for e in ev.get("fault_log", []):
            name = e.get("name", f"rule{e.get('rule')}")
            rules[name] = rules.get(name, 0) + 1
            sites[e["site"]] = sites.get(e["site"], 0) + 1
    return {
        "segments_reporting": len(events),
        "injections_fired": sum(rules.values()),
        "fired_rules": rules,
        "fired_sites": sites,
        "required_rules_fired": sorted(
            r for r in S.CHAOS_REQUIRED_RULES if r in rules),
        "commit_retries": sum(ev.get("commit_retries", 0) for ev in events),
        "fallback_restores": sum(
            1 for ev in events if ev.get("restored_from_fallback")),
        "replay_truncated": sum(
            ev.get("replay_truncated", 0) for ev in events),
        "prefetch_restarts": sum(
            ev.get("prefetch_restarts", 0) for ev in events),
    }


if __name__ == "__main__":
    main()
