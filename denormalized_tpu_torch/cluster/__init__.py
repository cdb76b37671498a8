"""Multi-process scale-out runtime.

Counterpart of ``denormalized_tpu/cluster/``: the same coordinator,
exchange wire format, checkpoint layout and rescale, with workers that
run their keyed half on the card (several workers share one).

The structural jump past one Python process (ROADMAP item 1): a
coordinator forks N engine **worker processes**, each owning a disjoint
static subset of the source's partitions (engine-owned assignment via
``Source.partition_factories()`` — no broker consumer groups), running
the existing prefetch/decode/operator pipeline locally.  Keyed operators
receive rows routed ``hash(key) % n_workers`` over a local-socket
**exchange** carrying column buffers (length-prefixed, CRC-framed like
checkpoints), with per-edge watermark merging and in-band barrier
alignment, so cluster checkpoints stay epoch-consistent and restore can
**rescale** — repartition checkpointed keyed + spilled state across a
changed worker count.

Layout::

    hashing.py      stable cross-process key hashing + partition math
    framing.py      exchange wire format (length-prefix + CRC32)
    exchange.py     sockets: server / client / edge merger (faults wired)
    split.py        logical-plan split at the keyed boundary
    runtime.py      ExchangeSourceExec / router / partition-subset source
    spec.py         ClusterSpec / job resolution (JSON round-trip)
    worker.py       worker process entry (python -m ...cluster.worker)
    coordinator.py  process supervision, aligned barriers, cluster commits
    rescale.py      re-bucket checkpointed state across a new worker count

See ``docs/cluster.md`` for the architecture and failure matrix.
"""

from denormalized_tpu_torch.cluster.coordinator import Coordinator, run_cluster
from denormalized_tpu_torch.cluster.spec import ClusterSpec

__all__ = ["ClusterSpec", "Coordinator", "run_cluster"]
