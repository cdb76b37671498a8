"""Typed metric instruments and the registry that owns them — counterpart
of ``denormalized_tpu/obs/registry.py``.

Design constraints:

- **Pre-bound handles.**  Operators bind instruments once at
  construction (``registry.counter(name, **labels)``); the hot path then
  does one attribute add — no dict lookups, no label formatting, no
  allocation.
- **No-op when disabled.**  A disabled registry hands out process-wide
  null singletons whose methods are empty (and which are *falsy*, so
  call sites can skip even the ``time.perf_counter()`` bracketing with
  ``if handle:``).  ``tests/test_torch_obs.py`` pins that the
  disabled-path call allocates nothing.
- **Single-writer mutation.**  Instruments carry NO locks: every bound
  handle has exactly one writer (an operator on the consumer thread, a
  prefetch worker for its own partition, the fault plan under its own
  lock).  Export readers tolerate the benign raciness of reading a
  counter mid-increment; what they can never see is a torn value, since
  every field is a single Python object reference, and ``observe()``
  stays a few attribute stores.

Histograms use exponential buckets declared in the catalog and track
exact ``sum``/``count``/``min``/``max`` alongside, so a soak can report
both interpolated percentiles and the true peak (a sampled gauge would
miss the max between samples).
"""

from __future__ import annotations

import threading
from bisect import bisect_right

from denormalized_tpu_torch.obs.catalog import declaration
from denormalized_tpu_torch.obs.readers import quantile_from_buckets


class Counter:
    """Monotone counter.  One writer per bound handle."""

    __slots__ = ("name", "labels", "_v")
    kind = "counter"

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._v = 0

    def add(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-written value.  One writer per bound handle."""

    __slots__ = ("name", "labels", "_v")
    kind = "gauge"

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self._v = 0.0

    def set(self, v) -> None:
        self._v = v

    @property
    def value(self):
        return self._v


class GaugeFn:
    """Pull-style gauge: ``fn()`` is evaluated at export time.  This is
    how the pre-existing ad-hoc counters (``decode_fallback_rows``, ...)
    migrate onto the registry without restructuring their ownership —
    the authoritative count stays where it lives, the registry reads it."""

    __slots__ = ("name", "labels", "fn")
    kind = "gauge"

    def __init__(self, name: str, labels: tuple, fn):
        self.name = name
        self.labels = labels
        self.fn = fn

    @property
    def value(self):
        try:
            return float(self.fn())
        except Exception:  # dnzlint: allow(broad-except) an export-time read of a torn-down source (closed pump, dead reader) must degrade to 0, never take the exposition endpoint down with it
            return 0.0


class Histogram:
    """Exponential-bucket histogram with exact sum/count/min/max.

    ``observe`` is the hot-path call: one bisect over ~20 floats plus
    five attribute stores.  Quantiles interpolate linearly inside the
    winning bucket (clamped by the exact min/max), which is the standard
    Prometheus-style estimate — good to a bucket factor, exact at the
    tails we report (max is tracked exactly)."""

    __slots__ = (
        "name", "labels", "bounds", "counts", "sum", "count", "vmin", "vmax"
    )
    kind = "histogram"

    def __init__(self, name: str, labels: tuple, bounds: list[float]):
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        if self.vmin is None or v < self.vmin:
            self.vmin = v

    @property
    def value(self):
        return self.sum

    def quantile(self, q: float) -> float | None:
        """Interpolated q-quantile (0..1) from the bucket counts, or
        None when empty."""
        return quantile_from_buckets(
            self.bounds, self.counts, self.count, q,
            vmin=self.vmin, vmax=self.vmax,
        )


class _NullInstrument:
    """Shared no-op handle for every kind when metrics are disabled.
    Falsy so call sites can skip timing brackets entirely:

        if self._obs_ms:            # False on the disabled path
            t0 = time.perf_counter()
    """

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def add(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    @property
    def value(self):
        return 0

    def quantile(self, q):
        return None


NULL = _NullInstrument()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Owns every bound instrument of one process (normally the
    module-global default in ``denormalized_tpu_torch.obs``).

    Binding is keyed ``(name, sorted labels)``: re-binding the same
    series returns the SAME instrument, so a restarted operator keeps
    accumulating into its series instead of shadowing it.  A
    ``gauge_fn`` re-bind replaces the callback (the new incarnation's
    closure is the live one)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    # -- binding --------------------------------------------------------
    def _bind(self, want_kind: str, name: str, labels: dict, factory):
        if not self.enabled:
            return NULL
        kind, _help, bounds = declaration(name)
        if kind != want_kind:
            raise TypeError(
                f"instrument {name!r} is declared as a {kind}, bound as "
                f"a {want_kind}"
            )
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory(name, key[1], bounds)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._bind(
            "counter", name, labels, lambda n, lk, _b: Counter(n, lk)
        )

    def gauge(self, name: str, **labels) -> Gauge:
        return self._bind(
            "gauge", name, labels, lambda n, lk, _b: Gauge(n, lk)
        )

    def histogram(self, name: str, **labels) -> Histogram:
        return self._bind(
            "histogram", name, labels,
            lambda n, lk, b: Histogram(n, lk, b),
        )

    def gauge_fn(self, name: str, fn, **labels) -> GaugeFn:
        inst = self._bind(
            "gauge", name, labels, lambda n, lk, _b: GaugeFn(n, lk, fn)
        )
        if isinstance(inst, GaugeFn):
            inst.fn = fn  # re-bind replaces the callback (see class doc)
        return inst

    # -- reading --------------------------------------------------------
    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> dict:
        """One JSON-able point-in-time view: series name (with rendered
        labels) -> scalar for counters/gauges, stats dict for
        histograms.  Histograms carry their raw bucket layout so
        multi-process consumers (the soak parent) can merge counts and
        re-derive quantiles over the union."""
        out: dict[str, object] = {}
        for inst in self.instruments():
            key = series_name(inst.name, inst.labels)
            if isinstance(inst, Histogram):
                out[key] = {
                    "count": inst.count,
                    "sum": inst.sum,
                    "min": inst.vmin,
                    "max": inst.vmax,
                    "bounds": inst.bounds,
                    "bucket_counts": list(inst.counts),
                    "p50": inst.quantile(0.50),
                    "p95": inst.quantile(0.95),
                    "p99": inst.quantile(0.99),
                }
            else:
                out[key] = inst.value
        return out


def series_name(name: str, labels: tuple) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{body}}}"
