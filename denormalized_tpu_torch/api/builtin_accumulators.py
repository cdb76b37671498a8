"""Built-in non-decomposable aggregates, implemented on the Accumulator
protocol and routed through :class:`UdafWindowExec`'s host frame path.

These are the aggregates that cannot decompose into the device kernel's
running components (sum/count/min/max/moments): exact order statistics,
value collection, and sketches.  The reference gets them from DataFusion
(`array_agg` with checkpoint serialization is prototyped at
crates/core/src/accumulators/serializable_accumulator.rs:10-68); ours
checkpoint through the same ``state()``/``merge()`` contract every user
UDAF uses, so kill/restore covers them for free.

Copy of ``denormalized_tpu/api/builtin_accumulators.py`` for the port
(host numpy in both packages; the same states, so snapshots interoperate).
"""

from __future__ import annotations

import math

import numpy as np

from denormalized_tpu_torch.api.udaf import Accumulator
from denormalized_tpu_torch.ops import sketches as _skx


def _jsonable_scalar(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.str_,)):
        return str(x)
    return x


class ArrayAggAccumulator(Accumulator):
    """Collect every value into a list (reference
    serializable_accumulator.rs:10-68 — the one accumulator it ships
    checkpoint serialization for)."""

    def __init__(self):
        self.values: list = []

    def update(self, col: np.ndarray) -> None:
        self.values.extend(_jsonable_scalar(v) for v in col.tolist())

    def merge(self, state) -> None:
        self.values.extend(state[0])

    def state(self) -> list:
        return [list(self.values)]

    def state_nbytes(self) -> int:
        return 64 + 64 * len(self.values)

    def evaluate(self):
        return list(self.values)


class MedianAccumulator(Accumulator):
    """Exact median (DataFusion `median`); state is the value list —
    UNBOUNDED growth, reported exactly via :meth:`state_nbytes` so the
    doctor's budget/growth verdicts (and spill pressure) see it."""

    def __init__(self):
        self.values: list[float] = []

    def update(self, col: np.ndarray) -> None:
        self.values.extend(float(v) for v in np.asarray(col, np.float64))

    def merge(self, state) -> None:
        self.values.extend(state[0])

    def state(self) -> list:
        return [list(self.values)]

    def state_nbytes(self) -> int:
        # 8 bytes payload + ~24 bytes of boxed-float overhead per entry;
        # derived from the element count, so restore-invariant
        return 64 + 32 * len(self.values)

    def evaluate(self):
        return float(np.median(self.values)) if self.values else math.nan


class FirstValueAccumulator(Accumulator):
    """First value in arrival order (DataFusion `first_value` with no
    explicit ordering: pick-any-deterministic)."""

    def __init__(self):
        self.value = None
        self.seen = False

    def update(self, col: np.ndarray) -> None:
        if not self.seen and len(col):
            self.value = _jsonable_scalar(col[0])
            self.seen = True

    def merge(self, state) -> None:
        if not self.seen and state[1]:
            self.value, self.seen = state[0], True

    def state(self) -> list:
        return [self.value, self.seen]

    def evaluate(self):
        return self.value


class LastValueAccumulator(Accumulator):
    def __init__(self):
        self.value = None
        self.seen = False

    def update(self, col: np.ndarray) -> None:
        if len(col):
            self.value = _jsonable_scalar(col[-1])
            self.seen = True

    def merge(self, state) -> None:
        if state[1]:
            self.value, self.seen = state[0], True

    def state(self) -> list:
        return [self.value, self.seen]

    def evaluate(self):
        return self.value


class CountDistinctAccumulator(Accumulator):
    """Exact distinct count (DataFusion ``count(distinct x)``); state is
    the value set (jsonable list)."""

    def __init__(self):
        self.seen: set = set()

    def update(self, col: np.ndarray) -> None:
        self.seen.update(_jsonable_scalar(v) for v in col.tolist())

    def merge(self, state) -> None:
        self.seen.update(state[0])

    def state(self) -> list:
        return [list(self.seen)]

    def state_nbytes(self) -> int:
        # ~64 bytes per set entry (hash slot + boxed value); derived
        # from the element count, so restore-invariant
        return 64 + 64 * len(self.seen)

    def evaluate(self) -> int:
        return len(self.seen)


class PercentileContAccumulator(Accumulator):
    """Exact continuous percentile (DataFusion ``approx_percentile_cont``'s
    exact cousin): linear interpolation over the sorted values."""

    def __init__(self, q: float):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile must be in [0, 1], got {q}")
        self.q = q
        self.values: list[float] = []

    def update(self, col: np.ndarray) -> None:
        self.values.extend(float(v) for v in np.asarray(col, np.float64))

    def merge(self, state) -> None:
        self.values.extend(state[0])

    def state(self) -> list:
        return [list(self.values)]

    def state_nbytes(self) -> int:
        return 64 + 32 * len(self.values)

    def evaluate(self):
        if not self.values:
            return math.nan
        return float(np.quantile(self.values, self.q))


class BitAndAccumulator(Accumulator):
    """Bitwise AND over int64 values (DataFusion ``bit_and``)."""

    _init = -1  # all bits set
    _op = staticmethod(lambda a, b: a & b)
    _ufunc = np.bitwise_and

    def __init__(self):
        self.acc = self._init
        self.seen = False

    def update(self, col: np.ndarray) -> None:
        vals = np.asarray(col, np.int64)
        if len(vals):
            self.seen = True
            self.acc = self._op(
                self.acc, int(type(self)._ufunc.reduce(vals))
            )

    def merge(self, state) -> None:
        if state[1]:
            self.acc = self._op(self.acc, int(state[0]))
            self.seen = True

    def state(self) -> list:
        return [self.acc, self.seen]

    def evaluate(self):
        return self.acc if self.seen else None


class BitOrAccumulator(BitAndAccumulator):
    _init = 0
    _op = staticmethod(lambda a, b: a | b)
    _ufunc = np.bitwise_or


class BitXorAccumulator(BitAndAccumulator):
    _init = 0
    _op = staticmethod(lambda a, b: a ^ b)
    _ufunc = np.bitwise_xor


class BoolAndAccumulator(Accumulator):
    """TRUE iff every value is true (DataFusion ``bool_and``)."""

    _all = True

    def __init__(self):
        self.acc = self._all
        self.seen = False

    def update(self, col: np.ndarray) -> None:
        vals = np.asarray(col, np.bool_)
        if len(vals):
            self.seen = True
            agg = bool(vals.all()) if self._all else bool(vals.any())
            self.acc = (self.acc and agg) if self._all else (self.acc or agg)

    def merge(self, state) -> None:
        if state[1]:
            self.seen = True
            self.acc = (
                (self.acc and state[0]) if self._all else (self.acc or state[0])
            )

    def state(self) -> list:
        return [bool(self.acc), self.seen]

    def evaluate(self):
        return bool(self.acc) if self.seen else None


class BoolOrAccumulator(BoolAndAccumulator):
    _all = False


class StringAggAccumulator(Accumulator):
    """Concatenate values with a delimiter in arrival order (DataFusion
    ``string_agg``)."""

    def __init__(self, delimiter: str = ","):
        self.delimiter = delimiter
        self.values: list[str] = []

    def update(self, col: np.ndarray) -> None:
        self.values.extend(
            str(v) for v in col.tolist() if v is not None
        )

    def merge(self, state) -> None:
        self.values.extend(state[0])

    def state(self) -> list:
        return [list(self.values)]

    def state_nbytes(self) -> int:
        return 64 + 64 * len(self.values)

    def evaluate(self):
        return self.delimiter.join(self.values) if self.values else None


class NthValueAccumulator(Accumulator):
    """N-th value in arrival order, 1-based (DataFusion ``nth_value``);
    keeps only the first N values, not the whole stream."""

    def __init__(self, n: int = 1):
        if n < 1:
            raise ValueError(f"nth_value position must be >= 1, got {n}")
        self.n = n
        self.values: list = []

    def update(self, col: np.ndarray) -> None:
        need = self.n - len(self.values)
        if need > 0:
            self.values.extend(
                _jsonable_scalar(v) for v in col.tolist()[:need]
            )

    def merge(self, state) -> None:
        need = self.n - len(self.values)
        if need > 0:
            self.values.extend(state[0][:need])

    def state(self) -> list:
        return [list(self.values)]

    def evaluate(self):
        return self.values[self.n - 1] if len(self.values) >= self.n else None


class TwoColStatsAccumulator(Accumulator):
    """Shared sufficient statistics for every bivariate aggregate —
    corr / covar_samp / covar_pop / the regr_* family (reference
    functions.py:1658-2066).  State is (n, Σx, Σy, Σxx, Σyy, Σxy) over
    pairwise-non-null pairs; each public aggregate is a finalizer over
    these six numbers.  Column convention follows DataFusion:
    ``(value_y, value_x)``."""

    stat = "corr"

    def __init__(self):
        self.n = 0
        self.sx = self.sy = self.sxx = self.syy = self.sxy = 0.0

    def update(self, ycol: np.ndarray, xcol: np.ndarray = None) -> None:
        if xcol is None:
            raise ValueError(f"{self.stat} takes two argument columns")
        y = np.asarray(ycol, np.float64)
        x = np.asarray(xcol, np.float64)
        ok = ~(np.isnan(x) | np.isnan(y))
        x, y = x[ok], y[ok]
        self.n += int(len(x))
        self.sx += float(x.sum())
        self.sy += float(y.sum())
        self.sxx += float((x * x).sum())
        self.syy += float((y * y).sum())
        self.sxy += float((x * y).sum())

    def merge(self, state) -> None:
        n, sx, sy, sxx, syy, sxy = state
        self.n += n
        self.sx += sx
        self.sy += sy
        self.sxx += sxx
        self.syy += syy
        self.sxy += sxy

    def state(self) -> list:
        return [self.n, self.sx, self.sy, self.sxx, self.syy, self.sxy]

    # centered moments (numerically fine for window-scale data; the
    # device kernel's compensated path is for the billion-row axis)
    def _mxx(self):
        return self.sxx - self.sx * self.sx / self.n

    def _myy(self):
        return self.syy - self.sy * self.sy / self.n

    def _mxy(self):
        return self.sxy - self.sx * self.sy / self.n

    def evaluate(self):
        import math as _m

        n = self.n
        if n == 0:
            # regr_count is 0 over an empty pair set (postgres/DataFusion);
            # every other bivariate stat is undefined -> NULL
            return 0 if self.stat == "regr_count" else None
        s = self.stat
        if s == "regr_count":
            return n
        if s == "regr_avgx":
            return self.sx / n
        if s == "regr_avgy":
            return self.sy / n
        if s == "regr_sxx":
            return self._mxx()
        if s == "regr_syy":
            return self._myy()
        if s == "regr_sxy":
            return self._mxy()
        if s == "covar_pop":
            return self._mxy() / n
        if s in ("covar", "covar_samp"):
            return self._mxy() / (n - 1) if n > 1 else None
        if s == "corr":
            d = _m.sqrt(self._mxx() * self._myy())
            return self._mxy() / d if d > 0 else None
        if s == "regr_slope":
            return self._mxy() / self._mxx() if self._mxx() != 0 else None
        if s == "regr_intercept":
            if self._mxx() == 0:
                return None
            slope = self._mxy() / self._mxx()
            return (self.sy - slope * self.sx) / n
        if s == "regr_r2":
            if self._mxx() == 0 or self._myy() == 0:
                return None
            r = self._mxy() / _m.sqrt(self._mxx() * self._myy())
            return r * r
        raise ValueError(f"unknown bivariate stat {s!r}")


class WeightedPercentileAccumulator(Accumulator):
    """Exact weighted continuous percentile (DataFusion
    ``approx_percentile_cont_with_weight``'s exact cousin)."""

    def __init__(self, q: float):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile must be in [0, 1], got {q}")
        self.q = q
        self.values: list[float] = []
        self.weights: list[float] = []

    def update(self, col: np.ndarray, wcol: np.ndarray = None) -> None:
        v = np.asarray(col, np.float64)
        w = (
            np.ones_like(v)
            if wcol is None
            else np.asarray(wcol, np.float64)
        )
        self.values.extend(v.tolist())
        self.weights.extend(w.tolist())

    def merge(self, state) -> None:
        self.values.extend(state[0])
        self.weights.extend(state[1])

    def state(self) -> list:
        return [list(self.values), list(self.weights)]

    def state_nbytes(self) -> int:
        return 64 + 64 * len(self.values)

    def evaluate(self):
        if not self.values:
            return math.nan
        v = np.asarray(self.values)
        w = np.asarray(self.weights)
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        cw = np.cumsum(w)
        total = cw[-1]
        if total <= 0:
            return math.nan
        # weighted quantile with linear interpolation on the cumulative
        # weight midpoints (the standard Hazen-type definition)
        mid = (cw - 0.5 * w) / total
        return float(np.interp(self.q, mid, v))


class ApproxDistinctAccumulator(Accumulator):
    """HyperLogLog distinct-count sketch (DataFusion `approx_distinct`).

    Thin shim over the shared :mod:`denormalized_tpu_torch.ops.sketches`
    kernels — the UDAF fallback lane of the first-class
    ``approx_distinct`` slice aggregate.  2^11 registers (~2.3%
    standard error), 64-bit stable hash (blake2b — NOT Python's salted
    ``hash``, which would break checkpoint/restore across processes);
    this class keeps its historical LOW-bit register-index convention
    (``h & (M-1)``), so checkpointed register state from earlier builds
    restores bit-for-bit.  State is the register list; merge is an
    elementwise max — the standard HLL union."""

    P = 11
    M = 1 << P

    def __init__(self):
        self.regs = np.zeros(self.M, dtype=np.int8)

    @classmethod
    def _hash64(cls, v) -> int:
        return _skx.blake2b64(v)

    def update(self, col: np.ndarray) -> None:
        vals = col.tolist()
        if not vals:
            return
        hs = np.fromiter(
            (_skx.blake2b64(v) for v in vals),
            dtype=np.uint64,
            count=len(vals),
        )
        idx = (hs & np.uint64(self.M - 1)).astype(np.int64)
        rest = hs >> np.uint64(self.P)
        # rank: position of first set bit in the remaining 64-P bits;
        # exact bit-length from the shared kernel (bit-identical to the
        # old per-row int.bit_length loop)
        width = np.uint64(64 - self.P)
        rank = (
            width + np.uint64(1) - _skx.u64_bit_length(rest)
        ).astype(np.int8)
        np.maximum.at(self.regs, idx, rank)

    def merge(self, state) -> None:
        self.regs = np.maximum(self.regs, np.asarray(state[0], dtype=np.int8))

    def state(self) -> list:
        return [self.regs.tolist()]

    def state_nbytes(self) -> int:
        return int(self.regs.nbytes)  # constant — the sketch's point

    def evaluate(self) -> int:
        m = float(self.M)
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / float(np.sum(2.0 ** (-self.regs.astype(np.float64))))
        zeros = int(np.sum(self.regs == 0))
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)  # linear counting, small range
        return int(round(est))


class ApproxTopKAccumulator(Accumulator):
    """Exact top-k heavy hitters for the ``approx_top_k`` UDAF fallback
    lane: a value → count dict, evaluated as ``[value, count]`` pairs
    count-descending (insertion order breaks ties, so the output is a
    pure function of the feed).  Unbounded in distinct values — the
    slice path's Space-Saving planes are the bounded-state lane; this
    accumulator reports its real growth via :meth:`state_nbytes`."""

    def __init__(self, k: int = 10):
        if k < 1:
            raise ValueError(f"approx_top_k needs k >= 1, got {k}")
        self.k = int(k)
        self.counts: dict = {}

    def update(self, col: np.ndarray) -> None:
        counts = self.counts
        for v in col.tolist():
            v = _jsonable_scalar(v)
            counts[v] = counts.get(v, 0) + 1

    def merge(self, state) -> None:
        counts = self.counts
        for v, c in state[0]:
            counts[v] = counts.get(v, 0) + int(c)

    def state(self) -> list:
        return [[[v, c] for v, c in self.counts.items()]]

    def state_nbytes(self) -> int:
        return 64 + 80 * len(self.counts)

    def evaluate(self) -> list:
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        return [[v, int(c)] for v, c in items[: self.k]]
