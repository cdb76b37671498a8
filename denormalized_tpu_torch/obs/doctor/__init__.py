"""denormalized_tpu_torch.obs.doctor — live query introspection.

The operator-facing half of the observability stack: where the
registry answers "what are the numbers", the doctor answers the two
questions an on-call human actually asks —

- **"which stage is the bottleneck right now?"** — every executing
  query registers its physical plan (node-id keyed, the same ids the
  checkpointer uses); per-operator busy time plus upstream queue-wait
  roll into ONE ranked suspect list under a documented attribution rule
  (:mod:`~denormalized_tpu_torch.obs.doctor.attribution`), rendered live at
  ``GET /queries/<id>/plan`` and by ``df.explain_analyze()``;
- **"why was this window late?"** — a configurable sample of rows is
  tagged at ingest with (source, partition, offset, event time) and
  followed through operator handoffs into window emission
  (:mod:`~denormalized_tpu_torch.obs.doctor.lineage`), queryable at
  ``GET /queries/<id>/lineage`` and drawn as Perfetto flow events on
  the span stream.

Plus an opt-in ~100 Hz sampling profiler exporting folded stacks for
flamegraphs (:mod:`~denormalized_tpu_torch.obs.doctor.profiler`), started and
stopped per query over HTTP.  See docs/observability.md §"Operating the
doctor".
"""

from __future__ import annotations

from denormalized_tpu_torch.obs.doctor.attribution import (  # noqa: F401
    ATTRIBUTION_RULE,
    rank,
)
from denormalized_tpu_torch.obs.doctor.registry import (  # noqa: F401
    QueryHandle,
    get_query,
    queries,
    register_query,
    register_shared,
    running_count,
)

__all__ = [
    "ATTRIBUTION_RULE", "QueryHandle", "get_query", "queries",
    "rank", "register_query", "register_shared", "running_count",
]
