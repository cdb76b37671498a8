"""State & skew observatory — counterpart of
``denormalized_tpu/obs/statewatch.py`` with what the join, the UDAF
operator and the session operators read:

1. **Exact state accounting** helpers (:func:`rb_nbytes`,
   :func:`acc_nbytes` and the documented per-object estimates) that a
   stateful operator's pull-only ``state_info()`` sums;
2. **A streaming key-distribution sketch** per join side:
   :class:`StateWatch` feeds one batch's dense gids into a Space-Saving
   heavy-hitter sketch right after intern time; the join's adaptation
   policy reads its top keys and total.

The HyperLogLog, the hot-key/skew summaries, the growth ring and its
time-to-budget forecast, the null watch of a metrics-off registry, the
exporters' gauge bindings and the doctor's verdicts wait for the slices
that port their readers.
"""

from __future__ import annotations

import numpy as np

from denormalized_tpu_torch.ops.sketches import SpaceSaving, _aggregate_gids

__all__ = ["SpaceSaving", "StateWatch", "acc_nbytes", "rb_nbytes"]


#: documented per-object estimates for state that lives in Python objects;
#: being constants, they make the accounting restore-invariant
KEY_EST_BYTES = 64  # one interned key: dict entry + row tuple + id
ACC_EST_BYTES = 512  # one accumulator object (UDAF/builtin, amortized)
OBJ_CELL_EST_BYTES = 56  # one object-dtype cell (string ref + header)


def acc_nbytes(acc) -> int:
    """Accounting bytes of one accumulator: its own ``state_nbytes()``
    when it reports one (the unbounded exact accumulators — median,
    count_distinct, percentile, array_agg — derive it from their element
    counts, so it is restore-invariant and grows with them), else the
    constant :data:`ACC_EST_BYTES` estimate."""
    fn = getattr(acc, "state_nbytes", None)
    if fn is None:
        return ACC_EST_BYTES
    return int(fn())


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


#: rows per sketch update: larger batches update through a CONTIGUOUS
#: block sample whose start rotates across updates, counts rescaled to row
#: units
SKETCH_ROW_CAP = 16_384

#: decay horizon for the JOIN's windowed sketches: one ×½ step every
#: quarter-million rows per side, so a retired celebrity's share halves
#: every ~256k rows and the adaptation policy's fold condition is
#: reachable in bounded rows
JOIN_SKETCH_DECAY_ROWS = 1 << 18


class StateWatch:
    """One join side's heavy-hitter sketch, windowed over
    ``JOIN_SKETCH_DECAY_ROWS``."""

    __slots__ = ("sketch", "_sample_phase")

    def __init__(self) -> None:
        self.sketch = SpaceSaving(64, decay_every=JOIN_SKETCH_DECAY_ROWS)
        self._sample_phase = 0

    def update(self, gids: np.ndarray) -> None:
        """Feed one batch's dense gids (call right after intern).  Batches
        beyond SKETCH_ROW_CAP update through a contiguous block sample
        whose start rotates over the valid range, counts scaled by the true
        sampling ratio."""
        n = len(gids)
        if n == 0:
            return
        g = gids if isinstance(gids, np.ndarray) else np.asarray(gids)
        sampled = False
        if n > SKETCH_ROW_CAP:
            sampled = True
            start = self._sample_phase % (n - SKETCH_ROW_CAP + 1)
            self._sample_phase = start + SKETCH_ROW_CAP
            g = g[start:start + SKETCH_ROW_CAP]
        u, c = _aggregate_gids(g)
        if sampled:
            c = np.rint(c * (n / len(g))).astype(np.int64)
        self.sketch.update_aggregated(u, c, n)

    def reset_sketches(self) -> None:
        """A re-intern replaced the gid space: old gids no longer name the
        same keys, so the sketch restarts and re-warms."""
        self.sketch.reset()
