"""Bottleneck attribution: turn per-node busy/wait numbers into ONE
ranked suspect list, so the slowest stage is *named*, never inferred by
the reader from raw series.

The attribution rule (documented in docs/observability.md and repeated
verbatim in every plan snapshot so a dashboard can render it next to the
ranking):

1. Every operator that brackets its batch processing reports **measured
   busy time** (``dnz_op_batch_ms`` — eval + device dispatch + emission
   assembly, with time suspended in downstream operators excluded).
2. Every operator also reports how long it spent **waiting on its
   upstream** to yield the next item (``dnz_op_input_wait_ms``).  In a
   pull pipeline that wait is exactly the upstream subtree's production
   time, so the *residual* of a node's input wait after subtracting its
   children's measured busy + wait is attributed to the children's
   un-bracketed work — for a leaf ``SourceExec`` that residual IS its
   fetch+decode time, which has no bracket of its own.  Multi-child
   nodes (the join, whose sides run on pump threads) split the residual
   evenly across children, a documented approximation.
3. A node's **total** = measured busy + attributed residual; its score
   is total / query wall time (the DS2-style busy fraction).  The node
   with the highest score is the named bottleneck.

The rule deliberately uses *time shares*, not rows/s: a stage can move
few rows slowly (a throttled UDF) or many rows quickly, and only the
share of wall time it consumes says which stage to fix first.
"""

from __future__ import annotations

ATTRIBUTION_RULE = (
    "rank = (measured batch-processing time + input-wait residual "
    "attributed from the consumer) / query wall time; the highest share "
    "is the named bottleneck.  A source's share is its consumer's input "
    "wait minus the measured time of everything between them (its own "
    "un-bracketed fetch+decode); multi-input operators split the "
    "residual evenly across inputs."
)


def rank(nodes: list[dict], wall_ms: float) -> list[dict]:
    """Ranked suspects from plan-node stat dicts (see
    ``QueryHandle.snapshot``).  Each input dict needs ``node_id``,
    ``label``, ``children`` (node ids), ``busy_ms``, ``input_wait_ms``.
    Returns one entry per node, most suspect first."""
    by_id = {n["node_id"]: n for n in nodes}
    attributed: dict[str, float] = {n["node_id"]: 0.0 for n in nodes}
    for n in nodes:
        kids = [by_id[c] for c in n.get("children", ()) if c in by_id]
        if not kids:
            continue
        accounted = sum(
            k.get("busy_ms", 0.0) + k.get("input_wait_ms", 0.0)
            for k in kids
        )
        residual = max(0.0, n.get("input_wait_ms", 0.0) - accounted)
        share = residual / len(kids)
        for k in kids:
            attributed[k["node_id"]] += share
    out = []
    for n in nodes:
        busy = float(n.get("busy_ms", 0.0))
        attr = attributed[n["node_id"]]
        total = busy + attr
        basis = (
            "measured" if attr == 0.0
            else "attributed" if busy == 0.0
            else "mixed"
        )
        out.append({
            "node_id": n["node_id"],
            "label": n.get("label", n["node_id"]),
            "busy_ms": round(busy, 3),
            "attributed_wait_ms": round(attr, 3),
            "total_ms": round(total, 3),
            "share_of_wall": round(total / wall_ms, 4) if wall_ms else 0.0,
            "basis": basis,
        })
    out.sort(key=lambda s: s["total_ms"], reverse=True)
    return out
