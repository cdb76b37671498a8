"""Mergeable sketch kernels — counterpart of
``denormalized_tpu/ops/sketches.py``, whole: the intern-time Space-Saving
summary the join's adaptation policy reads, the stable hashing helpers the
``approx_distinct`` accumulator calls, and the slice-store **sketch
planes** that make ``approx_distinct`` / ``approx_top_k`` /
``approx_percentile_cont`` first-class mergeable window aggregates on
:class:`~denormalized_tpu_torch.ops.slice_store.SliceStore`.

Host numpy, the same operations in the same order as the JAX package, so
both packages' planes are equal bit for bit (docs/approx_aggregates.md):

- **Deterministic, stable, never salted.**  Hashes are splitmix64 over
  canonical 64-bit value patterns (numeric lanes) or 8-byte blake2b
  digests (object lanes; a ``StringColumn`` hashes each unique value's
  UTF-8 bytes, as the object array of the same strings does) — process-
  independent, so kill/restore and shared-vs-independent runs produce
  byte-identical sketch state.  Python's salted ``hash()`` never appears.
- **Mergeable by construction.**  HLL registers fold by elementwise max,
  Space-Saving summaries by the mergeable-summaries union, KLL compactor
  levels by level-aligned re-insertion.  The slice store folds units in
  ascending order, so the fold tree is a pure function of the feed.
- **O(1) state per gid in value cardinality**: an HLL plane row is
  ``2^p`` bytes no matter how many distinct values it absorbed.

Imports numpy, math and hashlib only.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

__all__ = [
    "HLL_P",
    "KLL_K",
    "Hll",
    "HllSpec",
    "KllSpec",
    "SketchSpec",
    "SpaceSaving",
    "TopKSpec",
    "blake2b64",
    "hll_accumulate",
    "hll_estimate",
    "popcount64",
    "ss_admit",
    "stable_hash64",
    "topk_merge",
    "u64_bit_length",
]

#: default HLL precision for the approx_distinct slice lane: 2^12 = 4096
#: one-byte registers per (unit, gid) cell, ~1.6% standard error
HLL_P = 12

#: KLL/compactor level capacity: rank error after n inserts is bounded by
#: the sketch's own ``err`` accounting (one unit of level weight per
#: compaction), roughly ``log2(n / K) / K`` relative — ~2.1% at n = 1M
KLL_K = 512

_U64 = np.uint64
_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)
#: canonical quiet-NaN bit pattern (float64('nan') on every platform we
#: target) — all NaNs hash identically, mirroring the interner's NaN key
_NAN64 = np.float64("nan")


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wraparound arithmetic)."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def popcount64(x: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit population count (SWAR) — exact for the full
    uint64 range, unlike any float round-trip."""
    x = x - ((x >> np.uint64(1)) & _M1)
    x = (x & _M2) + ((x >> np.uint64(2)) & _M2)
    x = (x + (x >> np.uint64(4))) & _M4
    return (x * _H01) >> np.uint64(56)


def u64_bit_length(x: np.ndarray) -> np.ndarray:
    """Exact vectorized ``int.bit_length`` for uint64 arrays (0 → 0).

    Bit-smear then popcount — no float64 log2, so ranks are exact for
    ANY register width (the float path restricted the statewatch HLL to
    p >= 12; this lifts it, and the p=11 accumulator shim rides it)."""
    x = x | (x >> np.uint64(1))
    x = x | (x >> np.uint64(2))
    x = x | (x >> np.uint64(4))
    x = x | (x >> np.uint64(8))
    x = x | (x >> np.uint64(16))
    x = x | (x >> np.uint64(32))
    return popcount64(x)


def blake2b64(v) -> int:
    """Stable 8-byte blake2b digest of one Python value — the object-lane
    hash, and byte-compatible with the historical
    ``ApproxDistinctAccumulator._hash64`` canonical encoding."""
    if isinstance(v, bytes):
        b = v
    elif isinstance(v, str):
        b = v.encode()
    else:
        b = repr(v).encode()
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "little")


def _hash_object64(arr, valid: np.ndarray | None = None) -> np.ndarray:
    """Per-UNIQUE-value blake2b over an object column (deliberately
    unpinned: it loops distinct values, never rows — the
    SliceStore.accumulate precedent; repeated values pay one digest)."""
    obj = np.asarray(arr, dtype=object)
    n = len(obj)
    out = np.zeros(n, dtype=np.uint64)
    if valid is None:
        idx = None
        sub = obj
    else:
        idx = np.flatnonzero(valid)
        sub = obj[idx]
    if not len(sub):
        return out
    # None entries can't sort against other objects (np.unique would
    # raise); peel them off and hash them like any value — blake2b of
    # repr(None) — matching the exact-accumulator fallback, which feeds
    # unmasked Nones straight into its own blake2b
    none_mask = np.equal(sub, None)
    if none_mask.any():
        none_idx = np.flatnonzero(none_mask)
        tgt = none_idx if idx is None else idx[none_idx]
        out[tgt] = np.uint64(blake2b64(None))
        keep = np.flatnonzero(~none_mask)
        idx = keep if idx is None else idx[keep]
        sub = sub[keep]
        if not len(sub):
            return out
    uniq, inv = np.unique(sub, return_inverse=True)
    uh = np.empty(len(uniq), dtype=np.uint64)
    for i, v in enumerate(uniq.tolist()):
        uh[i] = np.uint64(blake2b64(v))
    if idx is None:
        out[:] = uh[inv]
    else:
        out[idx] = uh[inv]
    return out


def stable_hash64(col, valid: np.ndarray | None = None) -> np.ndarray:
    """Process-independent uint64 hash of one column (never salted).

    Numeric lanes canonicalize to a 64-bit pattern (−0.0 → +0.0, one
    NaN pattern; ints through int64 bits — integers beyond 2^53 keep
    exact identity, unlike a float round-trip) and run splitmix64 in
    one vectorized pass.  Object lanes dispatch to the per-unique
    blake2b path.  Rows where ``valid`` is False hash to an arbitrary
    value the caller must mask — validity is the caller's mask, not
    ours."""
    # a StringColumn reaches the object lane through ``__array__`` (its
    # materialized values): each unique value hashes as the object array
    # of the same strings does in the JAX package
    arr = col if isinstance(col, np.ndarray) else np.asarray(col)
    kind = arr.dtype.kind
    if kind in "iub":
        bits = arr.astype(np.int64, copy=False).view(np.uint64)
    elif kind == "f":
        x = arr.astype(np.float64, copy=True)
        zero = x == 0.0
        x[zero] = 0.0
        x[np.isnan(x)] = _NAN64
        bits = x.view(np.uint64)
    elif kind in "Mm":
        bits = arr.view(np.int64).view(np.uint64)
    else:
        return _hash_object64(arr, valid)
    return _mix64(bits)


def _aggregate_gids(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique gids, per-gid counts) of one batch.  Dense gid spaces
    (the normal case — interners hand out consecutive ids) take the
    O(n + max_gid) bincount path instead of the O(n log n) sort that
    ``np.unique`` costs; the sketch update must stay microseconds at
    8k-row batches."""
    mx = int(g.max())
    if mx < 4 * len(g) + 1024:
        bc = np.bincount(g)
        u = np.nonzero(bc)[0]
        return u, bc[u]
    u, c = np.unique(g.astype(np.int64, copy=False), return_counts=True)
    return u, c


# -- Space-Saving heavy hitters ------------------------------------------


def ss_admit(
    keys: np.ndarray, counts: np.ndarray, errs: np.ndarray,
    u: np.ndarray, c: np.ndarray,
) -> None:
    """Vectorized Space-Saving admission of pre-aggregated (key, count)
    pairs into one summary's slot arrays, in place.  Hits scatter-add;
    misses take the lowest-count victims, inheriting the evicted count
    as their error bound — ``count - err <= true <= count`` for every
    tracked key.  Shared by :class:`SpaceSaving` (statewatch's
    intern-time sketch) and the slice store's per-gid
    :class:`TopKSpec` planes."""
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
        # admission guard: sequential Space-Saving only ever evicts
        # the MINIMUM slot, whose count stays near the smallest base
        # as it churns — so a newcomer may only take a victim whose
        # count is within its own batch mass of that minimum.
        # Without this, a batch with >= K new keys would pair its
        # smallest newcomer against the LARGEST victim and evict a
        # genuine heavy hitter (caught by the skew smoke test).
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
    """Vectorized Space-Saving (Metwally et al.) over dense int gids.

    K slots of (key, count, err).  ``update`` aggregates the batch with
    one ``np.unique`` and applies hits as a scatter-add; new keys
    replace the lowest-count slots, inheriting the evicted count as
    their error bound — ``count - err <= true count <= count`` for
    every tracked key.  All numpy, no per-row Python.

    With ``decay_every`` > 0 the sketch is WINDOWED: every
    ``decay_every`` rows fed, counts, error bounds, and the total are
    scaled by ``decay_factor`` — an exponential moving window with a
    half-life of ``decay_every / (1 - decay_factor) * ln2`` rows at the
    default factor ½.  Shares then track RECENT traffic: a retired
    celebrity's share decays geometrically instead of only as
    ``1/total`` growth, so the join adaptation policy's fold trigger
    fires promptly instead of holding stale heavy hitters for the rest
    of the run.  Default 0 (off) preserves the monotone sketch every
    other consumer (skew verdicts, hot-key gauges) was tuned against;
    the overestimate invariant ``count - err <= true(window)`` is
    preserved under decay because both sides of the bound scale
    together.
    """

    __slots__ = (
        "keys", "counts", "errs", "total", "decay_every", "decay_factor",
        "_since_decay",
    )

    def __init__(
        self,
        capacity: int = 64,
        *,
        decay_every: int = 0,
        decay_factor: float = 0.5,
    ) -> None:
        k = max(int(capacity), 8)
        self.keys = np.full(k, -1, dtype=np.int64)
        self.counts = np.zeros(k, dtype=np.int64)
        self.errs = np.zeros(k, dtype=np.int64)
        self.total = 0  # rows in the (possibly decayed) window
        self.decay_every = max(int(decay_every), 0)
        if not 0.0 < float(decay_factor) < 1.0:
            raise ValueError("decay_factor must be in (0, 1)")
        self.decay_factor = float(decay_factor)
        self._since_decay = 0

    def update(self, gids: np.ndarray) -> None:
        g = np.asarray(gids, dtype=np.int64)
        if len(g) == 0:
            return
        self.update_aggregated(*_aggregate_gids(g), len(g))

    def decay(self) -> None:
        """One decay step: scale counts, errors, and the total by
        ``decay_factor``; slots decayed to zero free up for new keys
        (their key stays until evicted — a zero-count slot is the first
        victim the admission pass picks)."""
        f = self.decay_factor
        self.counts = (self.counts * f).astype(np.int64)
        self.errs = (self.errs * f).astype(np.int64)
        self.total = int(self.total * f)
        self._since_decay = 0

    def update_aggregated(
        self, u: np.ndarray, c: np.ndarray, rows: int
    ) -> None:
        """Batch update from pre-aggregated (unique gids, counts) —
        the shape :func:`_aggregate_gids` produces once per batch so the
        HLL can share the same reduction."""
        if self.decay_every:
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
        """Drop all tracked keys (a re-intern invalidated the gid space);
        the sketch re-warms from subsequent traffic."""
        self.keys.fill(-1)
        self.counts.fill(0)
        self.errs.fill(0)
        self.total = 0
        self._since_decay = 0


def topk_merge(
    ka: np.ndarray, ca: np.ndarray, ea: np.ndarray,
    kb: np.ndarray, cb: np.ndarray, eb: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-wise mergeable-summaries union of two ``(G, S)`` Space-Saving
    planes (Agarwal et al.): keys in both sum counts and error bounds;
    a key tracked on one side only adds the OTHER side's minimum slot
    count (its maximum possible untracked mass there — 0 while that
    side still has empty slots) to both count and err; the union keeps
    the top S by count.  ``count - err <= true <= count`` is preserved
    for every retained key.  Fully vectorized across gid rows (axis-1
    sorts); deterministic: ties in count keep key-ascending order."""
    g, s = ka.shape
    sent = np.int64(np.iinfo(np.int64).max)
    min_a = np.where((ka >= 0).all(axis=1), ca.min(axis=1), 0)
    min_b = np.where((kb >= 0).all(axis=1), cb.min(axis=1), 0)
    keys = np.concatenate((ka, kb), axis=1)
    cnts = np.concatenate((ca, cb), axis=1).astype(np.int64)
    errs = np.concatenate((ea, eb), axis=1).astype(np.int64)
    from_b = np.zeros((g, 2 * s), dtype=bool)
    from_b[:, s:] = True
    empty = keys < 0
    keys = np.where(empty, sent, keys)
    cnts = np.where(empty, 0, cnts)
    errs = np.where(empty, 0, errs)
    ordk = np.argsort(keys, axis=1, kind="stable")
    ks = np.take_along_axis(keys, ordk, axis=1)
    cs = np.take_along_axis(cnts, ordk, axis=1)
    es = np.take_along_axis(errs, ordk, axis=1)
    fb = np.take_along_axis(from_b, ordk, axis=1)
    # a key occurs at most twice (once per side): dup marks the second
    # occurrence, which folds into the first and is then blanked
    dup = np.zeros_like(ks, dtype=bool)
    dup[:, 1:] = (ks[:, 1:] == ks[:, :-1]) & (ks[:, 1:] != sent)
    cs2 = cs.copy()
    es2 = es.copy()
    cs2[:, :-1] += np.where(dup[:, 1:], cs[:, 1:], 0)
    es2[:, :-1] += np.where(dup[:, 1:], es[:, 1:], 0)
    pair_head = np.zeros_like(dup)
    pair_head[:, :-1] = dup[:, 1:]
    single = (~dup) & (~pair_head) & (ks != sent)
    other_min = np.where(fb, min_a[:, None], min_b[:, None])
    cs2 += np.where(single, other_min, 0)
    es2 += np.where(single, other_min, 0)
    ks2 = np.where(dup, sent, ks)
    dead = ks2 == sent
    cs2 = np.where(dead, 0, cs2)
    es2 = np.where(dead, 0, es2)
    # top-S by count desc; ks2 is key-ascending per row, so a stable
    # sort on -count breaks ties key-ascending — deterministic
    ords = np.argsort(-cs2, axis=1, kind="stable")[:, :s]
    ko = np.take_along_axis(ks2, ords, axis=1)
    co = np.take_along_axis(cs2, ords, axis=1)
    eo = np.take_along_axis(es2, ords, axis=1)
    gone = ko == sent
    ko = np.where(gone, np.int64(-1), ko)
    co = np.where(gone, 0, co)
    eo = np.where(gone, 0, eo)
    return ko, co, eo


# -- HyperLogLog cardinality ---------------------------------------------


def hll_accumulate(
    plane: np.ndarray, gids: np.ndarray, hashes: np.ndarray
) -> None:
    """Batch max-insert into a ``(cap, 2^p)`` register plane, in place.

    Register index = top p hash bits, rank = leading-zero count of the
    remaining ``64-p`` bits + 1 (exact via :func:`u64_bit_length`).
    One ``np.sort`` over packed ``(cell << 6) | rho`` keys turns the
    scatter-max into last-of-run picks + one bounded fancy-index max —
    no ``ufunc.at``.  Max is associative and commutative, so the result
    is independent of row order AND of how the batch was split across
    calls — the property the slice fold relies on."""
    cap, m = plane.shape
    p = int(m - 1).bit_length()
    width = np.uint64(64 - p)
    idx = (hashes >> width).astype(np.int64)
    w = hashes & ((np.uint64(1) << width) - np.uint64(1))
    rho = (width + np.uint64(1) - u64_bit_length(w)).astype(np.uint64)
    flat = (gids.astype(np.int64) * m + idx).astype(np.uint64)
    key = (flat << np.uint64(6)) | rho
    ks = np.sort(key)
    cells = (ks >> np.uint64(6)).astype(np.int64)
    pick = np.concatenate(
        (np.flatnonzero(cells[1:] != cells[:-1]),
         np.asarray([len(cells) - 1], dtype=np.int64))
    )
    cid = cells[pick]
    r = (ks[pick] & np.uint64(63)).astype(plane.dtype)
    pf = plane.reshape(-1)
    pf[cid] = np.maximum(pf[cid], r)


def hll_estimate(plane: np.ndarray) -> np.ndarray:
    """Per-gid cardinality estimates for a ``(G, 2^p)`` register plane:
    the standard HLL harmonic-mean estimator with the linear-counting
    small-range correction — the same formula (and therefore the same
    answer) as :meth:`Hll.estimate`, vectorized across rows."""
    g, m = plane.shape
    alpha = 0.7213 / (1.0 + 1.079 / m)
    regs = plane.astype(np.float64)
    est = alpha * m * m / np.sum(np.exp2(-regs), axis=1)
    zeros = np.count_nonzero(plane == 0, axis=1)
    lc = m * np.log(m / np.maximum(zeros, 1).astype(np.float64))
    out = np.where((est <= 2.5 * m) & (zeros > 0), lc, est)
    return np.rint(out).astype(np.int64)


class Hll:
    """HyperLogLog over dense int gids; standard error 1.04/sqrt(2**p).

    The register update is one vectorized hash + scatter-max via
    :func:`hll_accumulate` on a single-row plane view.  Ranks come from
    the exact bit-smear :func:`u64_bit_length` (identical to the former
    float64 ``floor(log2)`` for every width that was legal then), so
    any p in [4, 16] is exact — the p >= 12 float-mantissa restriction
    is gone.
    """

    __slots__ = ("p", "m", "registers", "_alpha")

    def __init__(self, p: int = 12) -> None:
        if not 4 <= p <= 16:
            raise ValueError("Hll precision p must be in [4, 16]")
        self.p = p
        self.m = 1 << p
        self.registers = np.zeros(self.m, dtype=np.uint8)
        self._alpha = 0.7213 / (1.0 + 1.079 / self.m)

    def update(self, gids: np.ndarray) -> None:
        g = np.asarray(gids)
        if len(g) == 0:
            return
        hll_accumulate(
            self.registers.reshape(1, -1),
            np.zeros(len(g), dtype=np.int64),
            _mix64(g.astype(np.uint64)),
        )

    def estimate(self) -> float:
        regs = self.registers.astype(np.float64)
        est = self._alpha * self.m * self.m / float(np.sum(np.exp2(-regs)))
        zeros = int(np.count_nonzero(self.registers == 0))
        if est <= 2.5 * self.m and zeros:
            # small-range (linear counting) correction
            return self.m * math.log(self.m / zeros)
        return est

    def reset(self) -> None:
        self.registers.fill(0)


# -- slice-store sketch planes -------------------------------------------


class SketchSpec:
    """Plane layout + kernels for one sketch family on the slice store.

    A spec is STATELESS — sketch state lives in each slice unit's label
    dict next to the scalar AggComponent arrays, under labels prefixed
    ``<sid>|``.  The spec declares the layout (:meth:`init_planes`,
    :meth:`alloc_label`, :meth:`fill_for`), the per-batch per-unit
    accumulate kernel, the cross-unit fold, and finalization; the store
    owns capacity growth, snapshot, restore, and byte accounting
    generically through those hooks.  ``uses`` names the per-row source
    lane the exec must feed: ``"hash"`` (stable uint64 value hashes),
    ``"vid"`` (dense value-interner ids), or ``"f64"`` (the shared
    float64 value matrix)."""

    kind = ""
    uses = "f64"

    def __init__(self, sid: str, vcol: int) -> None:
        self.sid = sid
        self.vcol = int(vcol)

    def key(self) -> tuple:
        """Dedup identity across subscribers (kind, value column, params)."""
        raise NotImplementedError

    def owns(self, label: str) -> bool:
        return label.startswith(self.sid + "|")

    def init_planes(self, cap: int) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def alloc_label(self, label: str, cap: int) -> np.ndarray:
        """Fresh plane for ``label`` at capacity ``cap`` (restore of
        dynamically created labels)."""
        raise NotImplementedError

    def fill_for(self, label: str):
        """Neutral fill value for capacity growth of ``label``."""
        raise NotImplementedError

    def accumulate_unit(self, slot, cap, gids, col, valid) -> None:
        """Fold one unit's rows (gids ascending — the store's shared
        sort order) into the unit's planes."""
        raise NotImplementedError

    def fold(self, slots: list[dict], cap: int) -> dict[str, np.ndarray]:
        """Merge this spec's planes across ``slots`` (ascending unit
        order) into fresh arrays keyed by the same labels."""
        raise NotImplementedError


class HllSpec(SketchSpec):
    """``approx_distinct``: one ``(cap, 2^p)`` int8 register plane."""

    kind = "hll"
    uses = "hash"

    def __init__(self, sid: str, vcol: int, p: int = HLL_P) -> None:
        super().__init__(sid, vcol)
        self.p = int(p)
        self.m = 1 << self.p

    def key(self) -> tuple:
        return ("hll", self.vcol, self.p)

    @property
    def _label(self) -> str:
        return f"{self.sid}|regs"

    def init_planes(self, cap: int) -> dict[str, np.ndarray]:
        return {self._label: np.zeros((cap, self.m), dtype=np.int8)}

    def alloc_label(self, label: str, cap: int) -> np.ndarray:
        return np.zeros((cap, self.m), dtype=np.int8)

    def fill_for(self, label: str):
        return 0

    def accumulate_unit(self, slot, cap, gids, col, valid) -> None:
        if not valid.all():
            gids = gids[valid]
            col = col[valid]
        if not len(gids):
            return
        hll_accumulate(slot[self._label], gids, col)

    def fold(self, slots: list[dict], cap: int) -> dict[str, np.ndarray]:
        out = slots[0][self._label].copy()
        for s in slots[1:]:
            np.maximum(out, s[self._label], out=out)
        return {self._label: out}

    def finalize(self, rows: dict, gids: np.ndarray) -> np.ndarray:
        return hll_estimate(rows[self._label][gids])


class TopKSpec(SketchSpec):
    """``approx_top_k``: per-gid Space-Saving planes over dense value
    ids — ``(cap, S)`` keys/counts/errs with S = max(64, 8k) slots so
    the reported top k sit well inside the tracked set."""

    kind = "topk"
    uses = "vid"

    def __init__(self, sid: str, vcol: int, k: int) -> None:
        super().__init__(sid, vcol)
        self.k = int(k)
        if self.k <= 0:
            raise ValueError(f"approx_top_k needs k >= 1, got {k}")
        self.slots = max(64, 8 * self.k)

    def key(self) -> tuple:
        return ("topk", self.vcol, self.k)

    def init_planes(self, cap: int) -> dict[str, np.ndarray]:
        return {
            f"{self.sid}|k": np.full((cap, self.slots), -1, dtype=np.int64),
            f"{self.sid}|c": np.zeros((cap, self.slots), dtype=np.int64),
            f"{self.sid}|e": np.zeros((cap, self.slots), dtype=np.int64),
        }

    def alloc_label(self, label: str, cap: int) -> np.ndarray:
        fill = self.fill_for(label)
        return np.full((cap, self.slots), fill, dtype=np.int64)

    def fill_for(self, label: str):
        return -1 if label.endswith("|k") else 0

    def accumulate_unit(self, slot, cap, gids, col, valid) -> None:
        g = gids[valid].astype(np.int64)
        if not len(g):
            return
        v = col[valid].astype(np.int64)
        mult = np.int64(int(v.max()) + 1)
        ks = np.sort(g * mult + v)
        edges = np.flatnonzero(ks[1:] != ks[:-1]) + 1
        starts = np.concatenate((np.zeros(1, dtype=np.int64), edges))
        cnts = np.diff(np.append(starts, len(ks)))
        pk = ks[starts]
        pg = pk // mult
        pv = pk % mult
        ka = slot[f"{self.sid}|k"]
        ca = slot[f"{self.sid}|c"]
        ea = slot[f"{self.sid}|e"]
        ue = np.flatnonzero(pg[1:] != pg[:-1]) + 1
        us = np.concatenate((np.zeros(1, dtype=np.int64), ue))
        uend = np.append(ue, len(pg))
        # iterates distinct gids present in the unit, never rows — the
        # SliceStore.accumulate precedent; each admission is the
        # vectorized ss_admit kernel over that gid's slot row views
        for i, gg in enumerate(pg[us].tolist()):
            lo, hi = int(us[i]), int(uend[i])
            ss_admit(ka[gg], ca[gg], ea[gg], pv[lo:hi], cnts[lo:hi])

    def fold(self, slots: list[dict], cap: int) -> dict[str, np.ndarray]:
        ka = slots[0][f"{self.sid}|k"].copy()
        ca = slots[0][f"{self.sid}|c"].copy()
        ea = slots[0][f"{self.sid}|e"].copy()
        for s in slots[1:]:
            ka, ca, ea = topk_merge(
                ka, ca, ea,
                s[f"{self.sid}|k"], s[f"{self.sid}|c"], s[f"{self.sid}|e"],
            )
        return {f"{self.sid}|k": ka, f"{self.sid}|c": ca, f"{self.sid}|e": ea}

    def cell_top(
        self, keys_row: np.ndarray, counts_row: np.ndarray,
        errs_row: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k (vids, counts, errs) of one gid's summary, count-desc;
        ties keep slot order, which the fold makes deterministic."""
        live = np.flatnonzero((keys_row >= 0) & (counts_row > 0))
        order = live[np.argsort(-counts_row[live], kind="stable")][: self.k]
        return keys_row[order], counts_row[order], errs_row[order]


class KllSpec(SketchSpec):
    """``approx_percentile_cont`` / ``approx_median``: a deterministic
    compactor (MRL/KLL-style) quantile sketch per gid.

    Level ℓ holds up to K values of weight ``2^ℓ`` in a lazily
    allocated ``(cap, K)`` plane.  Overflow compacts: sort the level,
    keep the odd-indexed half of the even-length prefix at doubled
    weight one level up (any odd leftover stays).  Each compaction of
    level ℓ shifts any rank estimate by at most ``2^ℓ``; the per-gid
    ``err`` plane accumulates exactly that, so the sketch SELF-REPORTS
    a worst-case rank-error bound the test suite asserts against.
    Folding re-inserts the source's levels at their own level (weight
    preserved) and adds the error accounts — mergeability by
    re-insertion.  With level capacity K the bound after n inserts is
    ~``n · log2(n/K) / K`` absolute rank, i.e. ``log2(n/K)/K``
    relative (~2.1% at n = 1M for K = 512).  Deterministic keep-odd
    compaction — no RNG — so shared/independent/restored runs agree
    byte-for-byte."""

    kind = "kll"
    uses = "f64"

    def __init__(self, sid: str, vcol: int, K: int = KLL_K) -> None:
        super().__init__(sid, vcol)
        self.K = int(K)

    def key(self) -> tuple:
        return ("kll", self.vcol, self.K)

    def init_planes(self, cap: int) -> dict[str, np.ndarray]:
        return {f"{self.sid}|err": np.zeros(cap, dtype=np.int64)}

    def alloc_label(self, label: str, cap: int) -> np.ndarray:
        tail = label[len(self.sid) + 1:]
        if tail.startswith("v"):
            return np.full((cap, self.K), np.nan, dtype=np.float64)
        return np.zeros(cap, dtype=np.int64)

    def fill_for(self, label: str):
        tail = label[len(self.sid) + 1:]
        return np.nan if tail.startswith("v") else 0

    def _level(self, slot, lv: int, cap: int):
        vl = f"{self.sid}|v{lv}"
        cl = f"{self.sid}|c{lv}"
        if vl not in slot:
            slot[vl] = np.full((cap, self.K), np.nan, dtype=np.float64)
            slot[cl] = np.zeros(cap, dtype=np.int64)
        return slot[vl], slot[cl]

    def _insert_cell(self, slot, cap, gi: int, vals: np.ndarray, lv: int):
        err = slot[f"{self.sid}|err"]
        pend = np.asarray(vals, dtype=np.float64)
        while len(pend):
            v_arr, c_arr = self._level(slot, lv, cap)
            cnt = int(c_arr[gi])
            buf = np.concatenate((v_arr[gi, :cnt], pend)) if cnt else pend
            if len(buf) <= self.K:
                v_arr[gi, : len(buf)] = buf
                c_arr[gi] = len(buf)
                return
            buf = np.sort(buf, kind="stable")
            m2 = len(buf) - (len(buf) & 1)
            keep = buf[m2:]
            v_arr[gi, :] = np.nan
            v_arr[gi, : len(keep)] = keep
            c_arr[gi] = len(keep)
            err[gi] += np.int64(1) << np.int64(lv)
            pend = buf[1:m2:2]
            lv += 1

    def accumulate_unit(self, slot, cap, gids, col, valid) -> None:
        g = gids[valid]
        if not len(g):
            return
        v = col[valid]
        edges = np.flatnonzero(g[1:] != g[:-1]) + 1
        starts = np.concatenate((np.zeros(1, dtype=np.int64), edges))
        ends = np.append(edges, len(g))
        # distinct gids per unit, never rows (accumulate precedent);
        # the inner work is one sort per compaction cascade
        for i, gg in enumerate(g[starts].tolist()):
            self._insert_cell(
                slot, cap, int(gg), v[int(starts[i]):int(ends[i])], 0
            )

    def _levels_of(self, rows: dict) -> list[tuple[np.ndarray, np.ndarray]]:
        out = []
        lv = 0
        while f"{self.sid}|v{lv}" in rows:
            out.append((rows[f"{self.sid}|v{lv}"], rows[f"{self.sid}|c{lv}"]))
            lv += 1
        return out

    def fold(self, slots: list[dict], cap: int) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {
            f"{self.sid}|err": slots[0][f"{self.sid}|err"].copy()
        }
        for vl, cl in self._levels_of(slots[0]):
            lv = len([k for k in out if k.startswith(f"{self.sid}|v")])
            out[f"{self.sid}|v{lv}"] = vl.copy()
            out[f"{self.sid}|c{lv}"] = cl.copy()
        err_out = out[f"{self.sid}|err"]
        for s in slots[1:]:
            levels = self._levels_of(s)
            s_err = s[f"{self.sid}|err"]
            act = s_err > 0
            for _vl, cl in levels:
                act = act | (cl > 0)
            for gi in np.flatnonzero(act).tolist():
                for lv, (vl, cl) in enumerate(levels):
                    c = int(cl[gi])
                    if c:
                        self._insert_cell(out, cap, gi, vl[gi, :c], lv)
                err_out[gi] += s_err[gi]
        return out

    def finalize_quantile(
        self, rows: dict, gids: np.ndarray, q: float
    ) -> np.ndarray:
        """Per-gid nearest-lower-rank quantile from the folded levels:
        weighted rank target ``q * (W - 1)`` over the value-sorted
        (value, weight) items.  Exact (rank error 0) while no
        compaction ever fired; otherwise within the gid's self-reported
        ``err`` bound."""
        levels = self._levels_of(rows)
        out = np.full(len(gids), np.nan, dtype=np.float64)
        for i, gi in enumerate(np.asarray(gids).tolist()):
            vals, wts = [], []
            for lv, (vl, cl) in enumerate(levels):
                c = int(cl[gi])
                if c:
                    vals.append(vl[gi, :c])
                    wts.append(
                        np.full(c, np.int64(1) << np.int64(lv), np.int64)
                    )
            if not vals:
                continue
            v = np.concatenate(vals)
            w = np.concatenate(wts)
            o = np.argsort(v, kind="stable")
            v = v[o]
            cw = np.cumsum(w[o])
            t = q * float(cw[-1] - 1)
            idx = min(
                int(np.searchsorted(cw, t, side="right")), len(v) - 1
            )
            out[i] = v[idx]
        return out
