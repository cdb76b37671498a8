"""The plan registry: every executing query, introspectable live.

``register_query`` is called by the executor right after the physical
plan is built: it assigns the SAME deterministic DFS node ids the
checkpointer uses (``state.checkpoint.assign_node_ids`` — so a dashboard
series, a checkpoint key, and a doctor suspect all name one node the
same way), stamps each operator with its id, attaches the lineage
tracker when sampling is configured, and files a :class:`QueryHandle`
under a process-global registry the HTTP surface reads.

``QueryHandle.snapshot()`` is the one data model every consumer renders:
``/queries/<id>/plan``, ``df.explain_analyze()``, and the ranked
bottleneck attribution all come from it.  On ``finish()`` the final
snapshot is frozen and the operator-tree reference is DROPPED — the
registry keeps a bounded ring of finished queries for post-run lookups
without pinning window state or prefetch buffers in memory (the same
no-graph-pinning rule of the state gauge_fns).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from denormalized_tpu_torch.obs.doctor.attribution import ATTRIBUTION_RULE, rank

_LOCK = threading.Lock()
_RUNNING: dict[str, "QueryHandle"] = {}
_RECENT: deque = deque(maxlen=16)
_IDS = itertools.count(1)


class QueryHandle:
    """Introspection handle of one query execution."""

    def __init__(self, query_id: str, root, node_ids: dict[int, str],
                 config=None, registry=None, lineage=None, shared=None):
        self.query_id = query_id
        self.root = root
        self._node_ids = node_ids  # id(op) -> node_id
        self.config = config
        self.registry = registry
        self.lineage = lineage
        # multi-query sharing (runtime/multi_query.py): when this query
        # is one of N subscribers folding from a shared operator tree,
        # ``shared`` carries {"group_size", "member", "weight", "label",
        # "group"} and every shared node's busy time / input wait /
        # state bytes are reported SCALED by weight (1/N) so per-query
        # cost stays truthful — the attribution rule documented in
        # docs/multi_query.md.  None = exclusive tree (the normal path).
        self.shared = shared
        self.profiler = None
        # serializes profiler start/stop: the HTTP surface is a
        # ThreadingHTTPServer, so two concurrent /profile/start requests
        # must not both pass the running check and orphan a sampler
        self._profiler_lock = threading.Lock()
        self.started_unix = time.time()
        self._started_mono = time.monotonic()
        self._finished_mono: float | None = None
        self._final_snapshot: dict | None = None
        self._final_state: dict | None = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._finished_mono is None

    def wall_s(self) -> float:
        end = (
            self._finished_mono
            if self._finished_mono is not None
            else time.monotonic()
        )
        return max(1e-9, end - self._started_mono)

    def finish(self) -> None:
        """Freeze the final snapshot, stop a still-running profiler, and
        drop the operator tree (see module docstring)."""
        if self._finished_mono is not None:
            return
        # finished must be VISIBLE before the profiler claim: a
        # concurrent start_profiler then either sees it (and refuses) or
        # already installed its sampler, which the claim below stops
        self._finished_mono = time.monotonic()
        self.stop_profiler()
        self._final_snapshot = self._snapshot_live()
        from denormalized_tpu_torch.obs.doctor import statedoc

        try:
            # the query's own thread, its operators stopped: name the
            # final hot keys through the interner
            self._final_state = statedoc.state_snapshot(self, live=True)
        except Exception:  # dnzlint: allow(broad-except) freezing the final /state view races operator teardown by design — a finished query without a state snapshot is degraded, not broken
            self._final_state = None
        self.root = None
        self._node_ids = {}
        with _LOCK:
            _RUNNING.pop(self.query_id, None)
            _RECENT.append(self)

    # -- profiler ----------------------------------------------------------
    def start_profiler(self, hz: float | None = None):
        """Start (or return) the query's sampler; None when the query
        already finished.  The finished re-check happens UNDER the lock:
        finish() marks finished before its stop_profiler claim, so a
        start racing the query's end either loses the check here or its
        fresh sampler is claimed-and-stopped by finish — never a leaked
        100 Hz thread taxing later queries."""
        from denormalized_tpu_torch.obs.doctor.profiler import SamplingProfiler

        with self._profiler_lock:
            if not self.running:
                return None
            if self.profiler is not None and self.profiler.running:
                return self.profiler
            if hz is None:
                hz = getattr(self.config, "profiler_hz", 100.0)
            self.profiler = SamplingProfiler(hz=hz).start()
            return self.profiler

    def _profiler_snapshot(self) -> dict:
        """Status dict for /queries/<id> — claim the reference under
        the lock (same idiom as stop_profiler) so a snapshot racing
        start/stop sees one coherent sampler, then read off the claimed
        local."""
        with self._profiler_lock:
            prof = self.profiler
        return {
            "running": bool(prof and prof.running),
            "samples": getattr(prof, "samples_taken", 0),
        }

    def stop_profiler(self) -> int:
        # claim the reference under the lock, join OUTSIDE it (stop()
        # joins the sampler thread; blocking under a held lock is the
        # DNZ-L002 class).  A concurrent double-stop is harmless —
        # SamplingProfiler.stop is idempotent.
        with self._profiler_lock:
            prof = self.profiler
        if prof is None:
            return 0
        return prof.stop()

    # -- the data model ----------------------------------------------------
    def _walk(self):
        """(op, node_id, parent_node_id) over the live tree."""
        if self.root is None:
            return
        stack = [(self.root, None)]
        while stack:
            op, parent = stack.pop()
            nid = self._node_ids.get(id(op))
            yield op, nid, parent
            for c in getattr(op, "children", ()):
                stack.append((c, nid))

    def _node_stats(self, op, node_id, parent, wall_s) -> dict:
        """One node's live stats.  Every read is a plain attribute load
        off the single-writer operator — defensive defaults, no locks —
        so a snapshot racing operator teardown degrades, never raises."""
        busy_ms = float(getattr(op, "_dr_busy_ms", 0.0))
        wait_ms = float(getattr(op, "_dr_input_wait_s", 0.0)) * 1e3
        rows_in = int(getattr(op, "_dr_rows_in", 0))
        n = {
            "node_id": node_id,
            "label": _safe_label(op),
            "parent": parent,
            "children": [
                self._node_ids.get(id(c))
                for c in getattr(op, "children", ())
            ],
            "rows_in": rows_in,
            "batches": int(getattr(op, "_dr_batches", 0)),
            "busy_ms": round(busy_ms, 3),
            "busy_frac": round(busy_ms / (wall_s * 1e3), 4),
            "input_wait_ms": round(wait_ms, 3),
            "input_wait_frac": round(wait_ms / (wall_s * 1e3), 4),
            "rows_per_s": round(rows_in / wall_s, 1),
        }
        # source nodes: rows OUT of the reader + prefetch backpressure
        pump = getattr(op, "_pump", None)
        if pump is not None:
            try:
                workers = pump.workers
                n["queue_depth"] = sum(
                    max(0, w.enq_rowful - w.deq_rowful) for w in workers
                )
                n["queue_depth_limit"] = pump.depth * len(workers)
            except Exception:  # dnzlint: allow(broad-except) a live scrape racing pump teardown reads half-dead workers — degrade to no queue numbers, never 500 the introspection surface
                pass
        metrics = {}
        try:
            metrics = op.metrics() or {}
        except Exception:  # dnzlint: allow(broad-except) op.metrics() touching torn-down readers mid-scrape must degrade to {}, not take the endpoint down
            metrics = {}
        if "rows_out" in metrics:
            n["rows_out"] = metrics["rows_out"]
            n["rows_per_s"] = round(metrics["rows_out"] / wall_s, 1)
        # stateful operators carry an event-time watermark
        wm = getattr(op, "_watermark_ms", None)
        if wm is None:
            wm = getattr(op, "_watermark", None)
        if isinstance(wm, (int, float)):
            n["watermark_lag_ms"] = round(time.time() * 1000.0 - wm, 1)
        # state observatory columns (stateful operators only)
        try:
            sinfo = op._cached_state_info()
        except Exception:  # dnzlint: allow(broad-except) accounting races operator teardown (single-writer, lock-free) — degrade to no state columns, never 500 the plan endpoint
            sinfo = None
        if sinfo:
            n["state_bytes"] = int(sinfo.get("state_bytes") or 0)
            n["state_keys"] = int(sinfo.get("live_keys") or 0)
            n["state_slots"] = [
                int(sinfo.get("slot_live") or 0),
                int(sinfo.get("slot_capacity") or 0),
            ]
            if sinfo.get("oldest_event_lag_ms") is not None:
                n["state_oldest_lag_ms"] = sinfo["oldest_event_lag_ms"]
            try:
                from denormalized_tpu_torch.obs.statewatch import side_live_keys

                skews = [
                    w.skew_factor(side_live_keys(sinfo, s))
                    for s, w, _r in op._state_watch_views() if w
                ]
                skews = [s for s in skews if s is not None]
                if skews:
                    n["state_skew"] = max(skews)
            except Exception:  # dnzlint: allow(broad-except) sketch reads race the operator thread like the accounting above — skew is an optional column
                pass
        if metrics:
            n["metrics"] = {
                k: v for k, v in metrics.items()
                if isinstance(v, (int, float))
            }
        if self.shared is not None:
            # shared-operator attribution: this tree serves group_size
            # queries at once, so THIS query's truthful cost share of
            # every node is its weight fraction of the measured totals.
            # With a weight_fn (the slice operator's per-subscriber cost
            # ledger) that fraction is MEASURED — a subsumption member
            # paying an expensive residual re-filter shows its real
            # share; without one, the even 1/group_size split applies.
            w = float(self.shared.get("weight", 1.0))
            fn = self.shared.get("weight_fn")
            if fn is not None:
                try:
                    w = float(fn())
                except Exception:  # dnzlint: allow(broad-except) the ledger read races the operator thread like every accounting read above — fall back to the even split
                    pass
            for k in ("busy_ms", "busy_frac", "input_wait_ms",
                      "input_wait_frac"):
                n[k] = round(n[k] * w, 4)
            if "state_bytes" in n:
                n["state_bytes"] = int(n["state_bytes"] * w)
            n["shared"] = {
                "subscribers": self.shared.get("group_size"),
                "fraction": round(w, 6),
            }
        return n

    def _snapshot_live(self) -> dict:
        wall_s = self.wall_s()
        nodes = [
            self._node_stats(op, nid, parent, wall_s)
            for op, nid, parent in self._walk()
        ]
        # render in DFS-preorder (node ids are "<i>_<Class>")
        nodes.sort(key=lambda n: _node_ord(n["node_id"]))
        suspects = rank(nodes, wall_s * 1e3)
        snap = {
            "query_id": self.query_id,
            "state": "running" if self.running else "finished",
            "started_unix": self.started_unix,
            "wall_s": round(wall_s, 3),
            "nodes": nodes,
            "attribution": {
                "rule": ATTRIBUTION_RULE,
                "suspects": suspects,
                "bottleneck": suspects[0]["node_id"] if suspects else None,
            },
            "profiler": self._profiler_snapshot(),
        }
        if self.lineage is not None:
            snap["lineage_samples"] = self.lineage.sampled_total
        if self.shared is not None:
            # the weight_fn callable is snapshot machinery, not payload
            # (the JSON route serializes this dict verbatim)
            snap["shared"] = {
                k: v for k, v in self.shared.items() if k != "weight_fn"
            }
        return snap

    def snapshot(self) -> dict:
        if self._final_snapshot is not None:
            return self._final_snapshot
        return self._snapshot_live()

    def state_snapshot(self) -> dict:
        """The state observatory's /state payload (live, or the frozen
        final view for a finished query)."""
        if self._final_state is not None:
            return self._final_state
        from denormalized_tpu_torch.obs.doctor import statedoc

        return statedoc.state_snapshot(self)

    # -- rendering ---------------------------------------------------------
    def render(self) -> str:
        """The annotated plan tree + named bottleneck, from the current
        (or frozen final) snapshot."""
        snap = self.snapshot()
        by_id = {n["node_id"]: n for n in snap["nodes"]}
        roots = [n for n in snap["nodes"] if n["parent"] is None]
        lines: list[str] = [
            f"== {snap['query_id']} ({snap['state']}, "
            f"wall {snap['wall_s']}s) =="
        ]

        def emit(n: dict, depth: int) -> None:
            ann = [
                f"rows/s={n['rows_per_s']:,.0f}",
                f"busy={n['busy_ms']:.1f}ms ({n['busy_frac'] * 100:.1f}%)",
                f"wait={n['input_wait_ms']:.1f}ms",
            ]
            if "queue_depth" in n:
                ann.append(
                    f"qdepth={n['queue_depth']}/{n['queue_depth_limit']}"
                )
            if "watermark_lag_ms" in n:
                ann.append(f"wm_lag={n['watermark_lag_ms']:.0f}ms")
            if "state_bytes" in n:
                ann.append(
                    f"state={_fmt_bytes(n['state_bytes'])}/"
                    f"{n['state_keys']}keys"
                )
                if n.get("state_skew") is not None and n["state_skew"] >= 2:
                    ann.append(f"skew={n['state_skew']:.1f}")
            lines.append(
                "  " * depth + f"{n['node_id']}  [{', '.join(ann)}]"
            )
            for c in n["children"]:
                if c in by_id:
                    emit(by_id[c], depth + 1)

        for r in roots:
            emit(r, 0)
        sus = snap["attribution"]["suspects"]
        if sus:
            top = sus[0]
            lines.append(
                f"bottleneck: {top['node_id']} — "
                f"{top['share_of_wall'] * 100:.1f}% of wall "
                f"({top['basis']}: busy {top['busy_ms']:.1f}ms + "
                f"attributed {top['attributed_wait_ms']:.1f}ms)"
            )
            for i, s in enumerate(sus[1:4], start=2):
                lines.append(
                    f"  {i}. {s['node_id']} "
                    f"{s['share_of_wall'] * 100:.1f}%"
                )
        lines.append(f"rule: {ATTRIBUTION_RULE}")
        return "\n".join(lines)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024.0
    return f"{n:.1f}GB"  # pragma: no cover — loop always returns


def _safe_label(op) -> str:
    try:
        return op._label()
    except Exception:  # dnzlint: allow(broad-except) a label built from live operator state can race teardown — the class name is always available and always correct
        return type(op).__name__


def _node_ord(node_id) -> int:
    try:
        return int(str(node_id).split("_", 1)[0])
    except ValueError:
        return 1 << 30


# -- process-global registry ------------------------------------------------


def register_query(root, config=None, registry=None) -> QueryHandle | None:
    """File one executing query; returns None when the doctor is
    disabled (``EngineConfig(doctor_enabled=False)``)."""
    if config is not None and not getattr(config, "doctor_enabled", True):
        return None
    from denormalized_tpu_torch.state.checkpoint import assign_node_ids

    node_ids = assign_node_ids(root)
    lineage = None
    every = getattr(config, "lineage_sample_every", None)
    if every:
        from denormalized_tpu_torch.obs.doctor.lineage import LineageTracker

        lineage = LineageTracker(
            int(every),
            max_samples=getattr(config, "lineage_max_samples", 256),
        )
    handle = QueryHandle(
        f"q{next(_IDS)}", root, node_ids,
        config=config, registry=registry, lineage=lineage,
    )
    _stamp_and_bind(root, node_ids, registry, lineage)
    with _LOCK:
        _RUNNING[handle.query_id] = handle
    return handle


def _stamp_and_bind(root, node_ids, registry, lineage=None) -> None:
    """Stamp every operator once: node id for attribution/lineage
    keying, tracker for the handoff/emission hooks (base defaults are
    None, so un-doctored trees — direct build_physical callers — stay
    inert).  Stateful operators also bind their state-observatory
    gauges here — the node id IS the series label, and it only exists
    now.  Binds must land in the query's resolved registry even when
    the caller sits outside the executor's binding context.  Shared by
    register_query and register_shared so the binding rules cannot
    diverge between single- and multi-query registration."""
    import contextlib

    from denormalized_tpu_torch import obs as _obs

    bind_ctx = (
        _obs.bound_registry(registry) if registry is not None
        else contextlib.nullcontext()
    )
    with bind_ctx:
        stack = [root]
        while stack:
            op = stack.pop()
            nid = node_ids.get(id(op))
            op._dr_node_id = nid
            op._dr_lineage = lineage
            if nid is not None:
                try:
                    op.bind_state_obs(nid)
                except Exception:  # dnzlint: allow(broad-except) a test double subclassing ExecOperator with a partial surface must not break query registration — its state gauges simply don't bind
                    pass
            stack.extend(getattr(op, "children", ()))


def register_shared(
    root, count: int, config=None, registry=None, labels=None
) -> list["QueryHandle"]:
    """File ``count`` subscriber queries over ONE shared operator tree
    (the multi-query runtime's registration): each gets its own query
    id and a ``shared`` descriptor with weight ``1/count``, so
    ``/queries/<id>/plan`` and ``/queries/<id>/state`` report that
    query's truthful cost share of the shared nodes.  When the root
    measures per-subscriber cost (``shared_fractions()`` — the slice
    operator's ledger of re-filter + accumulate + fold time), each
    descriptor also carries a ``weight_fn`` resolving the ACTUAL
    fraction at snapshot time: under subsumption sharing a member with
    an expensive residual predicate costs more than 1/N, and the even
    split would lie.  The tree is stamped and its state gauges bound
    ONCE (under the first handle) — the registry must not bind
    duplicate gauge series per subscriber.  One shared LineageTracker
    (when ``lineage_sample_every`` is set) serves every member: the
    slice operator tags emissions with the member's query id via the
    ``_dr_mq_qids`` stamp, and each handle's ``/lineage`` filters to
    its own.  Returns [] when the doctor is disabled."""
    if config is not None and not getattr(config, "doctor_enabled", True):
        return []
    from denormalized_tpu_torch.state.checkpoint import assign_node_ids

    node_ids = assign_node_ids(root)
    qids = [f"q{next(_IDS)}" for _ in range(count)]
    lineage = None
    every = getattr(config, "lineage_sample_every", None)
    if every:
        from denormalized_tpu_torch.obs.doctor.lineage import LineageTracker

        lineage = LineageTracker(
            int(every),
            max_samples=getattr(config, "lineage_max_samples", 256),
        )
    fractions = getattr(root, "shared_fractions", None)

    def _weight_fn_for(tag: int):
        if fractions is None:
            return None

        def weight() -> float:
            return float(fractions().get(tag, 1.0 / count))

        return weight

    handles = []
    for i, qid in enumerate(qids):
        handles.append(
            QueryHandle(
                qid, root, node_ids, config=config, registry=registry,
                lineage=lineage,
                shared={
                    "group_size": count,
                    "member": i,
                    "weight": 1.0 / count,
                    "weight_fn": _weight_fn_for(i),
                    "label": labels[i] if labels else None,
                    "group": qids,
                },
            )
        )
    _stamp_and_bind(root, node_ids, registry, lineage)
    # subscriber tag → query id, read by the slice operator's emission
    # hook to tag lineage links per member query
    root._dr_mq_qids = {i: qid for i, qid in enumerate(qids)}
    with _LOCK:
        for h in handles:
            _RUNNING[h.query_id] = h
    return handles


def get_query(query_id: str) -> QueryHandle | None:
    with _LOCK:
        h = _RUNNING.get(query_id)
        if h is not None:
            return h
        for h in _RECENT:
            if h.query_id == query_id:
                return h
    return None


def queries() -> list[QueryHandle]:
    """Running queries first (newest last), then the retained finished
    ring."""
    with _LOCK:
        return list(_RUNNING.values()) + list(_RECENT)


def running_count() -> int:
    with _LOCK:
        return len(_RUNNING)


def counts() -> tuple[int, int]:
    """(running, retained-finished) under ONE lock acquisition, so a
    liveness payload can never show a torn (e.g. negative) count."""
    with _LOCK:
        return len(_RUNNING), len(_RECENT)
