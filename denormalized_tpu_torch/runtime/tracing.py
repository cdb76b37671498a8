"""Logging and spans — counterpart of ``denormalized_tpu/runtime/tracing.py``
trimmed to what the state code calls: the package logger and :func:`span`
(enter/close log lines with wall time and error status when
:func:`enable_tracing` is on).  The span recorder and Perfetto dump of the
JAX package are not ported.
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


@contextlib.contextmanager
def span(name: str, **fields):
    """Span with enter/close log lines; the close line carries the entry
    fields and the error status (``status=ExcType`` when the body
    raised)."""
    if not _TRACING:
        yield
        return
    t0 = time.perf_counter()
    logger.info("enter %s %s", name, fields or "")
    err: str | None = None
    try:
        yield
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        logger.info(
            "close %s time.busy=%.3fms status=%s %s",
            name, (time.perf_counter() - t0) * 1e3, err or "ok", fields or "",
        )
