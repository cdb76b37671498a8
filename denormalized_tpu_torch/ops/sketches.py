"""Streaming heavy-hitter sketch over dense gids — counterpart of the
Space-Saving part of ``denormalized_tpu/ops/sketches.py`` (the intern-time
sketch the join's adaptation policy reads) — and the stable hashing helpers
the ``approx_distinct`` accumulator calls (``blake2b64``,
``u64_bit_length``).  The HyperLogLog planes and the slice store's sketch
kinds wait for the slices that port their readers.

The sketch is fed DENSE GIDS a batch at a time; updates are numpy (one
per-gid aggregation + scatter adds), never per-row Python.
"""

from __future__ import annotations

import hashlib

import numpy as np

_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)


def popcount64(x: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit population count (SWAR), exact over uint64."""
    x = x - ((x >> np.uint64(1)) & _M1)
    x = (x & _M2) + ((x >> np.uint64(2)) & _M2)
    x = (x + (x >> np.uint64(4))) & _M4
    return (x * _H01) >> np.uint64(56)


def u64_bit_length(x: np.ndarray) -> np.ndarray:
    """Exact vectorized ``int.bit_length`` for uint64 arrays (0 → 0):
    bit-smear then popcount, no float log2."""
    x = x | (x >> np.uint64(1))
    x = x | (x >> np.uint64(2))
    x = x | (x >> np.uint64(4))
    x = x | (x >> np.uint64(8))
    x = x | (x >> np.uint64(16))
    x = x | (x >> np.uint64(32))
    return popcount64(x)


def blake2b64(v) -> int:
    """Stable 8-byte blake2b digest of one Python value (bytes as they are,
    ``str`` as UTF-8, anything else through ``repr``) — the same hash the
    JAX package's ``approx_distinct`` accumulator takes, so both packages'
    estimates agree exactly."""
    if isinstance(v, bytes):
        b = v
    elif isinstance(v, str):
        b = v.encode()
    else:
        b = repr(v).encode()
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "little")


def _aggregate_gids(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique gids, per-gid counts) of one batch: a bincount for dense gid
    spaces, ``np.unique`` otherwise."""
    mx = int(g.max())
    if mx < 4 * len(g) + 1024:
        bc = np.bincount(g)
        u = np.nonzero(bc)[0]
        return u, bc[u]
    u, c = np.unique(g.astype(np.int64, copy=False), return_counts=True)
    return u, c


def ss_admit(
    keys: np.ndarray, counts: np.ndarray, errs: np.ndarray,
    u: np.ndarray, c: np.ndarray,
) -> None:
    """Vectorized Space-Saving admission of pre-aggregated (key, count)
    pairs into one summary's slot arrays, in place.  Hits scatter-add;
    misses take the lowest-count victims, inheriting the evicted count as
    their error bound — ``count - err <= true <= count`` for every tracked
    key."""
    k = keys
    order = np.argsort(k, kind="stable")
    ks = k[order]
    pos = np.minimum(np.searchsorted(ks, u), len(ks) - 1)
    hit = ks[pos] == u
    np.add.at(counts, order[pos[hit]], c[hit])
    miss = ~hit
    if miss.any():
        mu = u[miss]
        mc = c[miss]
        # largest newcomers first when more new keys than slots
        mo = np.argsort(-mc, kind="stable")
        take = min(len(mu), len(k))
        mu = mu[mo[:take]]
        mc = mc[mo[:take]]
        victims = np.argsort(counts, kind="stable")[:take]
        base = counts[victims]
        # admission guard: sequential Space-Saving only ever evicts the
        # MINIMUM slot, so a newcomer may only take a victim whose count is
        # within its own batch mass of that minimum — else a batch with
        # >= K new keys would evict a genuine heavy hitter
        ok = base <= base[0] + mc
        if not ok.all():
            victims = victims[ok]
            mu = mu[ok]
            mc = mc[ok]
            base = base[ok]
        keys[victims] = mu
        errs[victims] = base
        counts[victims] = base + mc


class SpaceSaving:
    """Vectorized Space-Saving (Metwally et al.) over dense int gids: K
    slots of (key, count, err), ``count - err <= true count <= count``.

    The sketch is WINDOWED: every ``decay_every`` rows fed, counts, error
    bounds and the total halve, so shares track recent traffic (the join's
    adaptation policy folds a retired celebrity within a bounded row
    horizon)."""

    __slots__ = ("keys", "counts", "errs", "total", "decay_every",
                 "_since_decay")

    def __init__(self, capacity: int, decay_every: int) -> None:
        k = max(int(capacity), 8)
        self.keys = np.full(k, -1, dtype=np.int64)
        self.counts = np.zeros(k, dtype=np.int64)
        self.errs = np.zeros(k, dtype=np.int64)
        self.total = 0  # rows in the decayed window
        self.decay_every = int(decay_every)
        self._since_decay = 0

    def decay(self) -> None:
        """One decay step: halve counts, errors and the total."""
        f = 0.5
        self.counts = (self.counts * f).astype(np.int64)
        self.errs = (self.errs * f).astype(np.int64)
        self.total = int(self.total * f)
        self._since_decay = 0

    def update_aggregated(
        self, u: np.ndarray, c: np.ndarray, rows: int
    ) -> None:
        """Batch update from pre-aggregated (unique gids, counts)."""
        self._since_decay += int(rows)
        if self._since_decay >= self.decay_every:
            self.decay()
        self.total += int(rows)
        ss_admit(self.keys, self.counts, self.errs, u, c)

    def top(self, k: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(gids, counts, errs) of the top-k tracked keys, count-desc."""
        live = np.nonzero(self.keys >= 0)[0]
        if len(live) == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy(), e.copy()
        order = live[np.argsort(-self.counts[live], kind="stable")][:k]
        return (
            self.keys[order].copy(),
            self.counts[order].copy(),
            self.errs[order].copy(),
        )

    def reset(self) -> None:
        """Drop all tracked keys (a re-intern invalidated the gid space)."""
        self.keys.fill(-1)
        self.counts.fill(0)
        self.errs.fill(0)
        self.total = 0
        self._since_decay = 0
