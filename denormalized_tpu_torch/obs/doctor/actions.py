"""Verdicts that act — counterpart of
``denormalized_tpu/obs/doctor/actions.py``: the doctor's closed control
loop for the join.

PRs 6–9 built the sense layer: every stateful operator feeds intern-time
Space-Saving sketches and the doctor ranks a ``skewed-join-side``
verdict when one key dominates a join side (statedoc.py).  Until now
every verdict was advisory.  :class:`JoinAdaptationPolicy` closes the
loop for the join: it consumes the operator's own sketch stream, applies
the SAME rule the verdict documents (top-1 share ≥ ``SKEW_SHARE_MIN``
AND share × live keys ≥ ``SKEW_FACTOR_MIN``), and issues the plan
adaptation — migrate the named key's rows into a dense hot
sub-partition (``_SideState.adapt``), fold it back when its share
decays (``fold``) — with hysteresis so a key oscillating around the
threshold doesn't thrash the layout.

Placement contract: the policy object is owned by the operator and
``tick`` runs ON THE JOIN'S OWN THREAD between batches (the executor
never calls it cross-thread) — layout migration must not race the
probe.  The doctor's role is the rule and the telemetry: every
adaptation increments ``dnz_join_adaptations_total`` (labeled
action=adapt|fold, side=left|right), lands as a Perfetto instant event
on the span stream, and is surfaced in ``state_info()["adaptations"]``
→ ``GET /queries/<id>/state``.

Two-tier rule with hysteresis:

- **trigger**: a side enters mitigation when its top-1 sketched key
  crosses the verdict thresholds (share ≥ ``adapt_share`` AND share ×
  live keys ≥ ``adapt_factor``) — or is already mitigated (has live
  hot blocks to manage);
- **adapt**: while triggered, EVERY tracked key with share ≥
  ``hot_share_min`` and share × live keys ≥ ``adapt_factor``
  sub-partitions, up to ``max_hot_keys`` concurrent blocks per side.
  A zipf-shaped feed's probe is serialized by the whole heavy-hitter
  set, not just the single verdict-crossing celebrity — adapting only
  the top key would leave the #2..#k chains as the next bottleneck;
- **fold** when a hot key's share has stayed below ``fold_share``
  (default half ``hot_share_min``) for ``hold_ticks`` CONSECUTIVE
  ticks.  Space-Saving counts are monotone, so a retired celebrity's
  share decays as total grows — folding is deliberately slower than
  adapting;
- decisions wait for ``min_rows`` sketched rows (a cold sketch names
  no hot keys), and a join re-intern resets the sketches — ``min_rows``
  then holds the policy off until they re-warm, so a reset never
  triggers a fold burst on stale zeros.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from denormalized_tpu_torch.obs.doctor.statedoc import (
    SKEW_FACTOR_MIN,
    SKEW_SHARE_MIN,
)

#: policy defaults (ctor-overridable; the TRIGGER thresholds are shared
#: with the skewed-join-side verdict so the loop acts exactly when the
#: doctor would have reported)
ADAPT_MIN_ROWS = 4096
HOT_SHARE_MIN = 0.002
FOLD_SHARE_RATIO = 0.5
FOLD_HOLD_TICKS = 3
MAX_HOT_KEYS = 32


class JoinAdaptationPolicy:
    """Closed-loop hot-key sub-partitioning for one StreamingJoinExec."""

    def __init__(
        self,
        *,
        adapt_share: float = SKEW_SHARE_MIN,
        adapt_factor: float = SKEW_FACTOR_MIN,
        hot_share_min: float = HOT_SHARE_MIN,
        fold_share: float | None = None,
        hold_ticks: int = FOLD_HOLD_TICKS,
        max_hot_keys: int = MAX_HOT_KEYS,
        min_rows: int = ADAPT_MIN_ROWS,
        interval_s: float = 1.0,
    ) -> None:
        self.adapt_share = float(adapt_share)
        self.adapt_factor = float(adapt_factor)
        self.hot_share_min = float(hot_share_min)
        self.fold_share = (
            self.hot_share_min * FOLD_SHARE_RATIO
            if fold_share is None else float(fold_share)
        )
        self.hold_ticks = int(hold_ticks)
        self.max_hot_keys = int(max_hot_keys)
        self.min_rows = int(min_rows)
        self.interval_s = float(interval_s)
        self._last_tick = 0.0
        # (side_id, gid) -> consecutive below-fold-threshold ticks
        self._cold_streak: dict[tuple[int, int], int] = {}
        self.events: deque = deque(maxlen=256)
        self.adaptations_total = 0
        # per action, changes applied (state_info reads them)
        self.counts = {"adapt": 0, "fold": 0}

    # -- operator-thread entry points ------------------------------------
    def maybe_tick(self, op, sides) -> None:
        """Rate-limited tick — one monotonic-clock check per batch."""
        now = time.monotonic()
        if now - self._last_tick < self.interval_s:
            return
        self._last_tick = now
        self.tick(op, sides)

    def tick(self, op, sides) -> None:
        """One policy evaluation over both sides' sketches."""
        for side_id, side in enumerate(sides):
            watch = op._sw if side_id == 0 else op._sw_right
            if not watch:
                continue
            sk = watch.sketch
            total = int(sk.total)
            if total < self.min_rows:
                continue
            live = int(np.count_nonzero(side.head >= 0)) + int(
                side.hot.nslots
            )
            gids, counts, _errs = sk.top(self.max_hot_keys)
            shares = {
                int(g): int(c) / total for g, c in zip(gids, counts)
            }
            # trigger: the verdict condition on the side's top key — or
            # the side is already mitigated and keeps managing its set
            top_share = max(shares.values(), default=0.0)
            triggered = side.hot.nslots > 0 or (
                top_share >= self.adapt_share
                and top_share * max(live, 1) >= self.adapt_factor
            )
            if triggered:
                for g, share in shares.items():
                    if (
                        share >= self.hot_share_min
                        and share * max(live, 1) >= self.adapt_factor
                        and side.hot.nslots < self.max_hot_keys
                        and not side.hot.contains(g)
                    ):
                        if side.adapt(g):
                            self._record(op, side_id, "adapt", g, share)
            for g in [int(x) for x in side.hot.gids()]:
                share = shares.get(g, 0.0)
                key = (side_id, g)
                if share < self.fold_share:
                    streak = self._cold_streak.get(key, 0) + 1
                    if streak >= self.hold_ticks:
                        side.fold(g)
                        self._cold_streak.pop(key, None)
                        self._record(op, side_id, "fold", g, share)
                    else:
                        self._cold_streak[key] = streak
                else:
                    self._cold_streak.pop(key, None)
        # drop streak entries whose key is no longer hot anywhere (a
        # re-intern renumbered gids, or a fold removed the block)
        live_hot = {
            (sid, int(g))
            for sid, s in enumerate(sides)
            for g in s.hot.gids()
        }
        for k in [k for k in self._cold_streak if k not in live_hot]:
            del self._cold_streak[k]

    # -- telemetry -------------------------------------------------------
    def _record(self, op, side_id: int, action: str, gid: int,
                share: float) -> None:
        from denormalized_tpu_torch import obs
        from denormalized_tpu_torch.ops.interner import display_keys

        side = "left" if side_id == 0 else "right"
        try:
            name = display_keys(op._interner, np.asarray([gid]))[0]
        except Exception:  # dnzlint: allow(broad-except) a racing re-intern may have retired the gid between decision and display resolution — degrade to the numeric label, never kill the join thread
            name = None
        ev = {
            "t": time.time(),
            "action": action,
            "side": side,
            "gid": int(gid),
            "key": str(name) if name is not None else f"gid:{int(gid)}",
            "share": round(float(share), 6),
        }
        self.events.append(ev)
        self.adaptations_total += 1
        self.counts[action] += 1
        # handles pre-bound by the operator at construction (the lint's
        # binder scan covers engine modules, and the event path should
        # allocate nothing)
        op._obs_adapt[(action, side)].add(1)
        rec = obs.spans.recorder()
        if rec is not None:
            rec.instant(f"join.{action}", dict(ev))
