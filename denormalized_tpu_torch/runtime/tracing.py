"""Logging and spans — counterpart of ``denormalized_tpu/runtime/tracing.py``:
the package logger and :func:`span`, which writes enter/close log lines
with wall time and error status when :func:`enable_tracing` is on, and
records into the span ring (``obs/spans.py``, dumped as Perfetto-loadable
Chrome trace JSON) when a recorder is installed
(``EngineConfig(trace_path=...)``); and :func:`collect_metrics` /
:func:`log_metrics`, the per-operator metrics of a plan tree (logged at the
end of a run while tracing is on).
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("denormalized_tpu_torch")

_TRACING = False


def enable_tracing(level: int = logging.INFO) -> None:
    global _TRACING
    _TRACING = True
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s %(message)s",
        )
    logger.setLevel(level)


def tracing_enabled() -> bool:
    return _TRACING


@contextlib.contextmanager
def span(name: str, **fields):
    """Span with two recording surfaces, each independently on:

    - log lines when :func:`enable_tracing` is on — the close line carries
      the entry fields and the error status (``status=ExcType`` when the
      body raised);
    - the structured ring recorder
      (:func:`denormalized_tpu_torch.obs.spans.enable_span_recording`),
      whose failed spans carry ``args.error``."""
    from denormalized_tpu_torch.obs import spans as obs_spans

    rec = obs_spans.recorder()
    if not _TRACING and rec is None:
        yield
        return
    t0 = time.perf_counter()  # dnzlint: allow(replay-impure) span timing is observability only; a span never feeds the bytes it brackets
    if _TRACING:
        logger.info("enter %s %s", name, fields or "")
    err: str | None = None
    try:
        yield
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        dur = time.perf_counter() - t0  # dnzlint: allow(replay-impure) span timing is observability only
        if _TRACING:
            logger.info(
                "close %s time.busy=%.3fms status=%s %s",
                name, dur * 1e3, err or "ok", fields or "",
            )
        if rec is not None:
            rec.record(name, t0, dur, fields or None, error=err)


def collect_metrics(root) -> dict[str, dict]:
    """Per-operator metrics over a physical plan tree, keyed by the same
    DFS ids used for checkpoint node ids."""
    from denormalized_tpu_torch.state.checkpoint import assign_node_ids, walk

    ids = assign_node_ids(root)
    out = {}
    for op in walk(root):
        m = op.metrics()
        if m:
            out[ids[id(op)]] = m
    return out


def log_metrics(root) -> None:
    if _TRACING:
        for node, m in collect_metrics(root).items():
            logger.info("metrics %s %s", node, m)
