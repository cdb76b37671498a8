"""denormalized_tpu_torch.obs — the metrics registry of the port.

Counterpart of ``denormalized_tpu/obs/__init__.py`` with counters, gauges
and histograms (sum and count) only: one process registry, module-level
binders, no exporters and no per-query scoping yet.  Bind once, update on
the hot path::

    from denormalized_tpu_torch import obs
    self._put_ms = obs.histogram("dnz_lsm_op_ms", op="put")
    ...
    self._put_ms.observe(ms)
"""

from __future__ import annotations

from denormalized_tpu_torch.obs.registry import (
    INSTRUMENTS,
    MetricsRegistry,
    series_name,
)

__all__ = [
    "INSTRUMENTS", "MetricsRegistry", "counter", "gauge", "histogram",
    "registry", "series_name",
]

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process registry."""
    return _REGISTRY


def counter(name: str, **labels):
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels):
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels):
    return _REGISTRY.histogram(name, **labels)
