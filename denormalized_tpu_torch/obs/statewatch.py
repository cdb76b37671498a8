"""State & skew observatory — counterpart of
``denormalized_tpu/obs/statewatch.py``, the measurement layer under every
stateful operator:

1. **Exact state accounting** — every stateful operator implements a
   pull-only ``state_info()`` (live bytes, live keys, slot capacity vs
   occupancy, oldest retained event time), computed when a snapshot or an
   exporter asks, never on the hot path; ``ExecOperator.bind_state_obs``
   binds its registry view through weakref'd gauge_fns.  On a CUDA ring
   the device bytes come from the kernel spec, never from a tensor read,
   so an exporter thread never touches the card.

2. **Streaming key-distribution sketches** — a Space-Saving heavy-hitter
   sketch and a HyperLogLog (``ops/sketches.py``), fed a batch's DENSE
   GIDS on the host right after intern time, through a rotating
   contiguous block sample of at most :data:`SKETCH_ROW_CAP` rows.
   Sketches do not ride checkpoints: after a restore they re-warm from
   live traffic, while exact accounting is recomputed from the restored
   state.

3. **Growth forecasting** — each watch keeps a bounded ring of (wall
   time, state bytes) samples, appended whenever an exporter or the
   doctor's ``/state`` endpoint reads the state-bytes gauge; a
   least-squares fit (:func:`obs.readers.linear_forecast`) projects
   time-to-budget against ``EngineConfig(state_budget_bytes=...)``.

With metrics disabled :func:`make_watch` hands out the shared falsy
:data:`NULL_WATCH`.  The doctor ranks the health verdicts from these
signals (:mod:`denormalized_tpu_torch.obs.doctor.statedoc`).
"""

from __future__ import annotations

import math
import time
from collections import deque

import numpy as np

from denormalized_tpu_torch.obs.readers import linear_forecast
from denormalized_tpu_torch.ops.sketches import (  # noqa: F401 - re-exports
    Hll,
    SpaceSaving,
    _aggregate_gids,
    _mix64,
)

__all__ = [
    "SpaceSaving", "Hll", "StateWatch", "NULL_WATCH", "arrays_nbytes",
    "acc_nbytes", "linear_forecast", "make_watch", "rb_nbytes",
    "side_live_keys",
]


def arrays_nbytes(*arrays) -> int:
    """Total nbytes of the given numpy arrays (None entries skipped)."""
    return sum(int(a.nbytes) for a in arrays if a is not None)


#: documented per-object estimates for state that lives in Python
#: objects (accounting for them exactly would mean walking user object
#: graphs on every export).  Being CONSTANTS makes the accounting
#: restore-invariant: bytes derive only from live counts, so the
#: pre-kill and post-restore numbers are identical by construction.
KEY_EST_BYTES = 64  # one interned key: dict entry + row tuple + id
ACC_EST_BYTES = 512  # one accumulator object (UDAF/builtin, amortized)
OBJ_CELL_EST_BYTES = 56  # one object-dtype cell (string ref + header)


def acc_nbytes(acc) -> int:
    """Accounting bytes of one accumulator: its own ``state_nbytes()``
    when it reports one (the unbounded exact accumulators — median,
    count_distinct, percentile, array_agg — derive it from their
    element counts, so it is restore-invariant AND actually grows),
    else the constant :data:`ACC_EST_BYTES` estimate.  Without this the
    doctor's unbounded-growth / budget-pressure verdicts were blind to
    exactly the accumulators most likely to OOM."""
    fn = getattr(acc, "state_nbytes", None)
    if fn is None:
        return ACC_EST_BYTES
    return int(fn())


def side_live_keys(info: dict, side) -> int:
    """Live keys of ONE watch view: the side's own count for a join
    ('left'/'right'), the node total otherwise.  Every skew-factor
    consumer must use this — a per-side sketch's top-1 share multiplied
    by the COMBINED both-sides key count would read ~2 on a perfectly
    uniform join and flag it skewed."""
    if side is not None:
        return int(
            info.get("sides", {}).get(side, {}).get("live_keys") or 0
        )
    return int(info.get("live_keys") or 0)


def rb_nbytes(batch) -> int:
    """Accounting bytes of one RecordBatch: exact nbytes for numeric
    columns and masks, the documented per-cell estimate for object
    (string) columns."""
    from denormalized_tpu_torch.common.columns import Column as _ColData

    total = 0
    for col, m in zip(batch.columns, batch.masks):
        if isinstance(col, _ColData):
            # columnar string/nested columns have EXACT buffer bytes (and
            # np.asarray here would build every Python row to count them)
            total += int(col.nbytes)
            if getattr(col, "_obj", None) is not None:
                # materialized (and cached) Python rows are resident too
                total += len(col) * OBJ_CELL_EST_BYTES
        elif col.dtype == object:
            total += len(col) * OBJ_CELL_EST_BYTES
        else:
            total += int(col.nbytes)
        if m is not None:
            total += int(np.asarray(m).nbytes)
    return total


#: rows per sketch update: batches beyond this update through a
#: CONTIGUOUS block sample whose start rotates across updates, with
#: counts rescaled to row units.  16k samples put the sampling error on
#: a heavy hitter's share around +-1% — far below the Space-Saving slot
#: guarantee — while capping the per-batch cost at ~0.1ms regardless of
#: how large source coalescing makes a batch.
SKETCH_ROW_CAP = 16_384


# -- sketches ------------------------------------------------------------
# SpaceSaving / Hll / _aggregate_gids live in ops/sketches.py (one
# implementation for these intern-time sketches, the slice store's
# approximate aggregates and the UDAF fallback); decay is a SpaceSaving
# constructor option, used only by the join.

#: decay horizon for the JOIN's windowed sketches: one decay step (×½)
#: every quarter-million rows per side ⇒ a retired celebrity's share
#: halves every ~256k rows regardless of run length, so the adaptation
#: policy's fold condition (share below fold_share for hold_ticks) is
#: reachable in bounded rows.  Other operators keep monotone sketches.
JOIN_SKETCH_DECAY_ROWS = 1 << 18


# -- the per-operator watch ----------------------------------------------


#: minimum seconds between two growth-ring samples (a Prometheus scrape
#: and a JSONL snapshot racing each other must not double-enter a point)
_SAMPLE_MIN_INTERVAL_S = 0.2

#: growth-ring depth: at the 1 s JSONL cadence this is ~8.5 minutes of
#: history — enough for a stable fit, bounded regardless of run length
_SAMPLE_RING = 512


class StateWatch:
    """One stateful operator's (or one join side's) sketch + growth set.

    Created unconditionally at operator construction; ``enabled``
    resolves from the bound registry's enabledness so the metrics-off
    path pays one attribute check per batch and nothing else (the exact
    accounting is pull-only and works either way)."""

    __slots__ = (
        "label", "enabled", "sketch", "hll", "update_s", "update_batches",
        "samples", "_last_sample_t", "_hot_bound", "_sample_phase",
    )

    def __init__(self, label: str, *, capacity: int = 64,
                 enabled: bool = True, decay_every: int = 0,
                 decay_factor: float = 0.5) -> None:
        self.label = label
        self.enabled = bool(enabled)
        self.sketch = SpaceSaving(
            capacity, decay_every=decay_every, decay_factor=decay_factor
        )
        self.hll = Hll()
        self.update_s = 0.0  # cumulative sketch-update cost (bench reports)
        self.update_batches = 0
        self.samples: deque = deque(maxlen=_SAMPLE_RING)
        self._last_sample_t = 0.0
        self._sample_phase = 0
        # hot-key gauge handles by key label (stale ones are zeroed, not
        # unbound — the registry has no eviction by design)
        self._hot_bound: dict = {}

    def __bool__(self) -> bool:
        return True

    # -- hot path --------------------------------------------------------
    def update(self, gids: np.ndarray) -> None:
        """Feed one batch's dense gids (call right after intern).  One
        shared per-gid aggregation feeds both sketches: the Space-Saving
        update works on (uniques, counts), and distinct-value sketches
        only care about the uniques, so the HLL hashes those — not the
        full batch.  Batches beyond SKETCH_ROW_CAP update through a
        CONTIGUOUS block sample whose start rotates across updates
        (counts scaled back to row units): contiguous keeps the memory
        traffic at one block regardless of batch size, rotation keeps
        the coverage uniform across the stream even when keys cluster
        within a batch."""
        n = len(gids)
        if not self.enabled or n == 0:
            return
        t0 = time.perf_counter()
        g = gids if isinstance(gids, np.ndarray) else np.asarray(gids)
        sampled = False
        if n > SKETCH_ROW_CAP:
            sampled = True
            # wrap the phase over the VALID start range [0, n - CAP], not
            # back to 0: constant-size batches would otherwise alternate
            # start 0 -> CAP -> 0 and never sample the tail rows past the
            # last full block (a partition appended last by coalescing
            # would be permanently invisible to the sketch)
            start = self._sample_phase % (n - SKETCH_ROW_CAP + 1)
            self._sample_phase = start + SKETCH_ROW_CAP
            g = g[start:start + SKETCH_ROW_CAP]
        u, c = _aggregate_gids(g)
        if sampled:
            # rescale by the TRUE sampling ratio (n / sample size), not
            # an integer ceiling: a 17k-row batch samples 16384 rows at
            # ratio ~1.04 — a ceil(17000/16384)=2 multiplier would
            # double every share and falsely trip skew verdicts
            c = np.rint(c * (n / len(g))).astype(np.int64)
        self.sketch.update_aggregated(u, c, n)
        self.hll.update(u)
        self.update_s += time.perf_counter() - t0
        self.update_batches += 1

    def reset_sketches(self) -> None:
        """A re-intern replaced the gid space: old gids no longer name
        the same keys, so the sketches restart (documented re-warm)."""
        self.sketch.reset()
        self.hll.reset()

    # -- growth ring -----------------------------------------------------
    def record_sample(self, bytes_now: float, t: float | None = None) -> None:
        """Append one (wall time, state bytes) growth point; rate-limited
        so concurrent exporters don't double-sample.  Called from the
        state-bytes gauge_fn (export-driven history) and from the
        doctor's /state snapshots."""
        now = time.time() if t is None else t
        if now - self._last_sample_t < _SAMPLE_MIN_INTERVAL_S:
            return
        self._last_sample_t = now
        self.samples.append((now, float(bytes_now)))

    def forecast(self, budget_bytes: int | None = None) -> dict | None:
        """Least-squares growth fit over the sample ring (None until two
        samples exist)."""
        return linear_forecast(list(self.samples), budget=budget_bytes)

    # -- distribution summaries -----------------------------------------
    def hot_keys(self, k: int = 8, resolve=None) -> list[dict]:
        """Top-k tracked keys: ``[{key, rows, err_rows, share}]``, share
        = tracked rows / total rows fed (the key's state-mass share for
        row-proportional state).  ``resolve(gids) -> list[str]`` maps
        dense gids to display keys; unresolvable gids (recycled/closed)
        render as ``gid:<n>``."""
        gids, counts, errs = self.sketch.top(k)
        total = max(self.sketch.total, 1)
        names = None
        if resolve is not None and len(gids):
            try:
                names = resolve(gids)
            except Exception:  # dnzlint: allow(broad-except) a hot gid may have been released/re-interned between sketch update and resolution — degrade to the numeric gid label, never take the state endpoint down
                names = None
        out = []
        for i in range(len(gids)):
            name = (
                str(names[i]) if names is not None and names[i] is not None
                else f"gid:{int(gids[i])}"
            )
            out.append({
                "key": name,
                "rows": int(counts[i]),
                "err_rows": int(errs[i]),
                "share": round(int(counts[i]) / total, 6),
            })
        return out

    def skew_factor(self, live_keys: int) -> float | None:
        """top-1 share x live keys: ~1 for a uniform distribution, >> 1
        when one key dominates (the PanJoin hot-key trigger signal)."""
        _gids, counts, _errs = self.sketch.top(1)
        if len(counts) == 0 or self.sketch.total == 0 or live_keys <= 0:
            return None
        return round(
            int(counts[0]) / self.sketch.total * live_keys, 3
        )

    def distinct_estimate(self) -> int:
        return int(round(self.hll.estimate()))

    def summary(self, live_keys: int = 0, resolve=None, k: int = 8) -> dict:
        """The sketch block of one node's /state payload."""
        return {
            "hot_keys": self.hot_keys(k, resolve=resolve),
            "skew_factor": self.skew_factor(live_keys),
            "distinct_gids_estimate": self.distinct_estimate(),
            "sketch_rows": self.sketch.total,
            "sketch_update_ms_total": round(self.update_s * 1e3, 3),
            "sketch_update_batches": self.update_batches,
            "enabled": self.enabled,
        }


class _NullWatch:
    """Falsy no-op watch (metrics-disabled path).  Exact accounting is
    unaffected (it never routes through the watch); sketches and the
    growth ring are simply off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def update(self, gids) -> None:
        pass

    def reset_sketches(self) -> None:
        pass

    def record_sample(self, bytes_now, t=None) -> None:
        pass

    def forecast(self, budget_bytes=None):
        return None

    def hot_keys(self, k=8, resolve=None):
        return []

    def skew_factor(self, live_keys):
        return None

    def distinct_estimate(self) -> int:
        return 0

    def summary(self, live_keys=0, resolve=None, k=8) -> dict:
        return {
            "hot_keys": [], "skew_factor": None,
            "distinct_gids_estimate": 0, "sketch_rows": 0,
            "sketch_update_ms_total": 0.0, "sketch_update_batches": 0,
            "enabled": False,
        }

    update_s = 0.0
    update_batches = 0
    samples: deque = deque()


NULL_WATCH = _NullWatch()


def make_watch(label: str, *, capacity: int = 64, decay_every: int = 0,
               decay_factor: float = 0.5):
    """A live :class:`StateWatch` when the currently bound registry has
    metrics enabled, else the shared falsy null — the same
    resolve-at-construction rule every obs handle follows.
    ``decay_every``/``decay_factor`` make the heavy-hitter sketch
    windowed (see :class:`SpaceSaving`) — the join passes them so its
    adaptation policy sees recent shares."""
    from denormalized_tpu_torch import obs

    if obs.enabled():
        return StateWatch(
            label, capacity=capacity,
            decay_every=decay_every, decay_factor=decay_factor,
        )
    return NULL_WATCH
