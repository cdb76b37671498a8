"""Verdicts that act — counterpart of
``denormalized_tpu/obs/doctor/actions.py``: the join's closed control loop.

:class:`JoinAdaptationPolicy` consumes the join operator's own sketch
stream, applies the skewed-join-side rule (top-1 share ≥ ``SKEW_SHARE_MIN``
AND share × live keys ≥ ``SKEW_FACTOR_MIN``), and issues the plan
adaptation — migrate the named key's rows into a dense hot sub-partition
(``_SideState.adapt``), fold it back when its share decays (``fold``) —
with hysteresis so a key oscillating around the threshold does not thrash
the layout.

Placement contract: the policy object is owned by the operator and
``tick`` runs ON THE JOIN'S OWN THREAD between batches — layout migration
must not race the probe.  Every adaptation increments
``dnz_join_adaptations_total`` (action=adapt|fold, side=left|right) and is
kept in ``events`` for ``state_info()["adaptations"]``.

Two-tier rule with hysteresis:

- **trigger**: a side enters mitigation when its top-1 sketched key
  crosses the verdict thresholds — or is already mitigated (has live hot
  blocks to manage);
- **adapt**: while triggered, EVERY tracked key with share ≥
  ``HOT_SHARE_MIN`` and share × live keys ≥ ``SKEW_FACTOR_MIN``
  sub-partitions, up to ``MAX_HOT_KEYS`` blocks per side;
- **fold** when a hot key's share has stayed below ``HOT_SHARE_MIN ×
  FOLD_SHARE_RATIO`` for ``FOLD_HOLD_TICKS`` CONSECUTIVE ticks;
- decisions wait for ``ADAPT_MIN_ROWS`` sketched rows, and a join
  re-intern resets the sketches — ``ADAPT_MIN_ROWS`` then holds the policy
  off until they re-warm.

The doctor's other verdicts, its HTTP surface and the span stream are not
ported.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

#: the skewed-join-side verdict's thresholds (the JAX package's
#: obs/doctor/statedoc.py): the loop acts exactly when the doctor would
#: have reported
SKEW_SHARE_MIN = 0.2
SKEW_FACTOR_MIN = 4.0

#: the policy's own thresholds
ADAPT_MIN_ROWS = 4096
HOT_SHARE_MIN = 0.002
FOLD_SHARE_RATIO = 0.5
FOLD_HOLD_TICKS = 3
MAX_HOT_KEYS = 32


class JoinAdaptationPolicy:
    """Closed-loop hot-key sub-partitioning for one StreamingJoinExec."""

    def __init__(self, *, interval_s: float = 1.0) -> None:
        self.interval_s = float(interval_s)
        self._last_tick = 0.0
        # (side_id, gid) -> consecutive below-fold-threshold ticks
        self._cold_streak: dict[tuple[int, int], int] = {}
        self.events: deque = deque(maxlen=256)
        self.adaptations_total = 0
        # per action, changes applied (state_info and chip_smoke read them)
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
            sk = (op._sw if side_id == 0 else op._sw_right).sketch
            total = int(sk.total)
            if total < ADAPT_MIN_ROWS:
                continue
            live = int(np.count_nonzero(side.head >= 0)) + int(
                side.hot.nslots
            )
            gids, counts, _errs = sk.top(MAX_HOT_KEYS)
            shares = {
                int(g): int(c) / total for g, c in zip(gids, counts)
            }
            # trigger: the verdict condition on the side's top key — or
            # the side is already mitigated and keeps managing its set
            top_share = max(shares.values(), default=0.0)
            triggered = side.hot.nslots > 0 or (
                top_share >= SKEW_SHARE_MIN
                and top_share * max(live, 1) >= SKEW_FACTOR_MIN
            )
            if triggered:
                for g, share in shares.items():
                    if (
                        share >= HOT_SHARE_MIN
                        and share * max(live, 1) >= SKEW_FACTOR_MIN
                        and side.hot.nslots < MAX_HOT_KEYS
                        and not side.hot.contains(g)
                    ):
                        if side.adapt(g):
                            self._record(op, side_id, "adapt", g, share)
            for g in [int(x) for x in side.hot.gids()]:
                share = shares.get(g, 0.0)
                key = (side_id, g)
                if share < HOT_SHARE_MIN * FOLD_SHARE_RATIO:
                    streak = self._cold_streak.get(key, 0) + 1
                    if streak >= FOLD_HOLD_TICKS:
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
        from denormalized_tpu_torch.ops.interner import display_keys

        side = "left" if side_id == 0 else "right"
        name = display_keys(op._interner, np.asarray([gid]))[0]
        self.events.append({
            "t": time.time(),
            "action": action,
            "side": side,
            "gid": int(gid),
            "key": str(name) if name is not None else f"gid:{int(gid)}",
            "share": round(float(share), 6),
        })
        self.adaptations_total += 1
        self.counts[action] += 1
        # handles pre-bound by the operator at construction
        op._obs_adapt[(action, side)].add(1)
