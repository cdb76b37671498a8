"""denormalized_tpu_torch.obs — engine-wide observability, the counterpart
of ``denormalized_tpu/obs/__init__.py``: typed instruments (Counter, Gauge,
Histogram with exponential buckets) declared once in
:mod:`~denormalized_tpu_torch.obs.catalog`, bound to pre-resolved handles at
operator construction, exported three ways —

- a Prometheus text-exposition endpoint on a stdlib HTTP server
  (``EngineConfig(prometheus_port=...)``, opt-in);
- periodic JSONL snapshots for soaks and benches
  (``EngineConfig(metrics_jsonl_path=...)``);
- a ring-buffered span recorder dumping Chrome trace-event JSON
  loadable in Perfetto (``EngineConfig(trace_path=...)``).

Hot-path contract: a bound handle's ``add``/``observe`` is one
attribute update (plus a ~20-element bisect for histograms); with
metrics disabled the handle is a falsy shared null object whose methods
are no-ops and allocate nothing.  Instruments are single-writer by
construction (one handle per operator/worker); export readers tolerate
mid-increment reads.  Registries are scoped per query
(:func:`bound_registry`, resolved by the executor from
``EngineConfig.metrics_enabled``); components that bind from their own
threads capture :func:`current_registry` where they are built.

Use module-level binders everywhere in the engine (binding an undeclared
name raises)::

    from denormalized_tpu_torch import obs
    self._rows_in = obs.counter("dnz_op_rows_in_total", op="window")
    ...
    self._rows_in.add(batch.num_rows)
"""

from __future__ import annotations

import contextlib
import threading

from denormalized_tpu_torch.obs import spans as spans
from denormalized_tpu_torch.obs.catalog import INSTRUMENTS
from denormalized_tpu_torch.obs.registry import (
    MetricsRegistry,
    NULL,
    series_name,
)
from denormalized_tpu_torch.obs.spans import (
    SpanRecorder,
    disable_span_recording,
    enable_span_recording,
)

__all__ = [
    "INSTRUMENTS", "MetricsRegistry", "NULL", "SpanRecorder",
    "counter", "gauge", "gauge_fn", "histogram", "enabled",
    "set_enabled", "registry", "use_registry", "series_name",
    "current_registry", "disabled_registry", "bound_registry",
    "enable_span_recording", "disable_span_recording", "spans",
    "start_exporters",
]

_REGISTRY = MetricsRegistry(enabled=True)

#: shared always-disabled registry: the per-query binding target for
#: executions with ``metrics_enabled=False`` (every bind returns NULL)
_DISABLED = MetricsRegistry(enabled=False)

# per-thread registry-binding stack (see bound_registry): executors push
# the registry a query resolved so every instrument bound while building
# and driving THAT query lands there — two concurrent queries with
# different metrics_enabled settings no longer fight over one global flag
_TLS = threading.local()


def registry() -> MetricsRegistry:
    """The process-default registry (what binds outside any query)."""
    return _REGISTRY


def current_registry() -> MetricsRegistry:
    """The registry module-level binders resolve against RIGHT NOW: the
    innermost :func:`bound_registry` on this thread, else the process
    default."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else _REGISTRY


def disabled_registry() -> MetricsRegistry:
    """The shared always-disabled registry (hands out falsy NULLs)."""
    return _DISABLED


@contextlib.contextmanager
def bound_registry(reg: MetricsRegistry):
    """Route this thread's module-level binders to ``reg`` for the
    duration.  Used by the executor to scope registry binding per query
    execution; long-lived components that bind instruments from their
    OWN threads (prefetch workers) capture ``current_registry()`` at
    construction and re-enter it on their thread, so a supervised
    rebuild mid-stream still binds to its query's registry.

    Exits remove THIS context's entry even when interleaved generators
    unwind out of order (a paused ``stream()`` holding an entry must not
    be popped by a sibling's exit)."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(reg)
    try:
        yield reg
    finally:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is reg:
                del stack[i]
                break


def use_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process registry (tests, bench isolation); returns the
    previous one so callers can restore it."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    return prev


def set_enabled(on: bool) -> None:
    """Flip metrics for instruments bound FROM NOW ON against the
    process-default registry (binding decides null vs live once, so the
    hot path never re-checks).  Per-query enablement is scoped by the
    executor via :func:`bound_registry` — this flag only governs binds
    outside any execution."""
    _REGISTRY.enabled = bool(on)


def enabled() -> bool:
    return current_registry().enabled


def counter(name: str, **labels):
    return current_registry().counter(name, **labels)


def gauge(name: str, **labels):
    return current_registry().gauge(name, **labels)


def histogram(name: str, **labels):
    return current_registry().histogram(name, **labels)


def gauge_fn(name: str, fn, **labels):
    return current_registry().gauge_fn(name, fn, **labels)


# -- per-execution exporters (started by the executor, opt-in) ------------


class Exporters:
    """Running exporters of one query execution; ``stop()`` is
    idempotent and flushes/dumps everything."""

    def __init__(self, prometheus=None, jsonl=None, trace_path=None,
                 installed_recorder=False):
        self.prometheus = prometheus
        self.jsonl = jsonl
        self._trace_path = trace_path
        self._installed_recorder = installed_recorder
        self._stopped = False

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self.jsonl is not None:
            self.jsonl.stop()
        if self.prometheus is not None:
            self.prometheus.stop()
        if self._trace_path is not None:
            rec = spans.recorder()
            if rec is not None:
                rec.dump(self._trace_path)
        if self._installed_recorder:
            # uninstall what WE installed: later queries must not keep
            # paying per-span record cost (or leak this run's events
            # into their traces); a user-installed recorder is left alone
            disable_span_recording()


def start_exporters(config, registry=None) -> Exporters | None:
    """Start whatever the config opted into; None when nothing is.
    Read with getattr so a caller-supplied config object predating these
    knobs (tests building bare namespaces) never breaks execution.
    ``registry`` scopes the exporters to one query's resolved registry
    (the executor passes it); default is the current binding."""
    port = getattr(config, "prometheus_port", None)
    jsonl_path = getattr(config, "metrics_jsonl_path", None)
    trace_path = getattr(config, "trace_path", None)
    trace_events = getattr(config, "trace_events", 0)
    if port is None and jsonl_path is None and trace_path is None:
        return None
    if registry is None:
        registry = current_registry()
    server = None
    if port is not None:
        from denormalized_tpu_torch.obs.prometheus import PrometheusServer

        server = PrometheusServer(registry, port=port).start()
    snap = None
    if jsonl_path is not None:
        from denormalized_tpu_torch.obs.jsonl import JsonlSnapshotter

        snap = JsonlSnapshotter(
            jsonl_path, registry,
            interval_s=getattr(config, "metrics_jsonl_interval_s", 1.0),
        ).start()
    installed = False
    if trace_path is not None and spans.recorder() is None:
        enable_span_recording(int(trace_events) or 65536)
        installed = True
    return Exporters(
        prometheus=server, jsonl=snap, trace_path=trace_path,
        installed_recorder=installed,
    )
