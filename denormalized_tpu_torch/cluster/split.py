"""Split a logical plan at the keyed boundary.

Counterpart of ``denormalized_tpu/cluster/split.py``.

A cluster worker runs the SAME query twice over, in two halves:

- the **ingest half** — ``Scan`` (restricted to the worker's partition
  subset) plus every stateless operator below the keyed one — feeds the
  exchange router, which hash-partitions rows on the keyed operator's
  group columns;
- the **keyed half** — the keyed operator and everything above it —
  reads from an :class:`ExchangeScan` leaf fed by the edge merger, so
  every group key is owned by exactly one worker.

The split happens AFTER the optimizer pass (projection pruning / filter
pushdown see the full plan; the exchange then ships only the pruned
columns), and is deliberately conservative about what it accepts:
exactly one keyed operator (a ``StreamingWindow`` of any window type),
column-only group exprs (the router hashes column values — a computed
group expr would need evaluation before routing; compute it with
``with_column`` first), and no joins (the two-input exchange is the
documented next step, docs/cluster.md#limitations).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.expr import Column


class ExchangeScan(lp.LogicalPlan):
    """Leaf standing in for the exchange's receive side.  Holds a live
    exec factory (the plan is built inside the worker process, never
    serialized), which the planner calls through its ``create_exec``
    extension point."""

    def __init__(self, schema: Schema, exec_factory: Callable) -> None:
        self.schema = schema
        self._exec_factory = exec_factory

    def create_exec(self, planner):
        return self._exec_factory()

    def _label(self) -> str:
        return "ExchangeScan"


@dataclass
class SplitQuery:
    """The two halves of one worker's query."""

    ingest_logical: lp.LogicalPlan  # Scan .. last stateless below keyed op
    keyed_builder: Callable[[lp.LogicalPlan], lp.LogicalPlan]
    key_columns: list[str]  # routing keys, in group-expr order
    exchange_schema: Schema  # row layout on the wire (pre-keyed-op)


def _chain(plan: lp.LogicalPlan) -> list[lp.LogicalPlan]:
    """Root→leaf chain of a purely unary plan; loud error on joins."""
    chain = []
    node = plan
    while True:
        chain.append(node)
        kids = node.children
        if not kids:
            return chain
        if len(kids) > 1 or isinstance(node, lp.Join):
            raise PlanError(
                "cluster mode supports single-input (non-join) plans — "
                "the two-input exchange is not built yet "
                "(docs/cluster.md#limitations)"
            )
        node = kids[0]


def _rebuild_above(
    chain_above: list[lp.LogicalPlan], new_input: lp.LogicalPlan
) -> lp.LogicalPlan:
    """Rebuild the nodes ABOVE the split point (given leaf→root order is
    reversed here: ``chain_above`` is root-first) onto ``new_input``."""
    node = new_input
    for orig in reversed(chain_above):
        if isinstance(orig, lp.Project):
            node = lp.Project(node, orig.exprs)
        elif isinstance(orig, lp.Filter):
            node = lp.Filter(node, orig.predicate)
        elif isinstance(orig, lp.StreamingWindow):
            node = lp.StreamingWindow(
                node,
                orig.group_exprs,
                orig.aggr_exprs,
                orig.window_type,
                orig.length_ms,
                orig.slide_ms,
            )
        elif isinstance(orig, lp.Sink):
            node = lp.Sink(node, orig.sink)
        else:
            raise PlanError(
                f"cluster mode cannot rebuild {type(orig).__name__} "
                "above the exchange"
            )
    return node


def split_keyed(plan: lp.LogicalPlan) -> SplitQuery:
    """Split an OPTIMIZED plan at its (single) keyed operator."""
    chain = _chain(plan)  # root .. leaf
    keyed = [n for n in chain if isinstance(n, lp.StreamingWindow)]
    if not keyed:
        raise PlanError(
            "cluster mode needs a keyed operator (window/session "
            "aggregation) — a stateless plan has nothing to exchange; "
            "run it single-process with more partitions instead"
        )
    if len(keyed) > 1:
        raise PlanError(
            "cluster mode supports exactly one keyed operator per plan "
            "(cascaded windowed aggregations would re-key mid-stream)"
        )
    win = keyed[0]
    key_columns: list[str] = []
    for g in win.group_exprs:
        if not isinstance(g, Column):
            raise PlanError(
                f"cluster mode routes on column group keys; {g!r} is a "
                "computed expression — materialize it with with_column "
                "before the window"
            )
        key_columns.append(g.name)
    if not key_columns:
        raise PlanError(
            "cluster mode needs at least one group column to hash-route "
            "on (a global aggregate has a single key and gains nothing "
            "from the exchange)"
        )
    idx = chain.index(win)
    above = chain[:idx]  # root .. node just above win
    ingest_logical = win.input

    def keyed_builder(exchange_leaf: lp.LogicalPlan) -> lp.LogicalPlan:
        rebuilt_win = lp.StreamingWindow(
            exchange_leaf,
            win.group_exprs,
            win.aggr_exprs,
            win.window_type,
            win.length_ms,
            win.slide_ms,
        )
        return _rebuild_above(above, rebuilt_win)

    return SplitQuery(
        ingest_logical=ingest_logical,
        keyed_builder=keyed_builder,
        key_columns=key_columns,
        exchange_schema=ingest_logical.schema,
    )
