"""Multi-process jobs — counterpart of
``denormalized_tpu/parallel/distributed.py`` on ``torch.distributed``.

The JAX package joins a multi-host job with ``jax.distributed.initialize``
and builds one mesh over every device of the job.  Here
:func:`init_distributed` joins a process group (gloo on the CPU, NCCL on
cards) and :func:`global_mesh` builds the job's key-axis mesh: process r
owns a contiguous block of positions, its own devices.  The sharded layouts
(``parallel/sharded_state.py``) then hold only their process's shards and
fold at emission with collectives: ``all_reduce`` (SUM/MIN/MAX) for the
partial layouts, ``all_gather`` for key-sharded reads.  Updates need none:
every process is fed the same batch, as the JAX package's replicated
inputs are.  Under a process group the planner builds an engine mesh
this way (:func:`job_devices`): ``EngineConfig(mesh_devices=n)`` counts the
job's shards, as ``jax.devices()`` counts the job's devices there.

Nothing on a host tells a process of its peers: pass the coordinator's
``host:port``, the process count and this process's id.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from denormalized_tpu_torch.parallel.mesh import (
    KEY_AXIS,
    Mesh,
    default_devices,
    devices_for,
    make_mesh,
)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a multi-process job.  No-op only when NOTHING multi-process was
    requested (no coordinator, no process id, ≤1 process), as in the JAX
    package.  Collectives run over gloo on the CPU and NCCL on cards
    (``cpu:gloo,cuda:nccl`` where CUDA is available, so CPU shards still
    fold); ``coordinator_address`` is ``host:port`` (a ``tcp://`` prefix is
    added)."""
    if (
        coordinator_address is None
        and process_id is None
        and num_processes in (None, 1)
    ):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs coordinator_address, num_processes "
            "and process_id (nothing on the host announces them)"
        )
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes),
        rank=int(process_id),
    )


def local_devices() -> list[torch.device]:
    """This process's cards, in index order; raises without one (a shard
    never moves to the CPU unasked: name CPU shards, as in
    ``global_mesh(devices=["cpu"] * k)``)."""
    devices = default_devices()
    if not devices:
        raise RuntimeError(
            "no visible card: pass the shards' devices explicitly "
            "(e.g. devices=['cpu'] * k)"
        )
    return devices


def local_device_count() -> int:
    """The visible cards (0 without CUDA)."""
    return len(default_devices())


def global_mesh(devices=None) -> Mesh:
    """Mesh over the ENTIRE job (every process's devices, process r's
    block at positions ``[r·L, (r+1)·L)``).  ``devices`` lists this
    process's devices (default :func:`local_devices`, which raises without
    a card; a device may repeat, to hold several shards); every process
    must list as many.  Outside a
    process group it is :func:`make_mesh` over ``devices``."""
    mine = list(local_devices() if devices is None else devices)
    if not dist.is_available() or not dist.is_initialized():
        return make_mesh(devices=mine)
    world = dist.get_world_size()
    counts = [None] * world
    dist.all_gather_object(counts, len(mine))
    if len(set(counts)) != 1:
        raise RuntimeError(
            f"processes list unequal device counts {counts}: every process "
            "must hold as many shards"
        )
    L = len(mine)
    # another process's devices are named as this one's (the same local
    # names on each host); only their owner addresses them
    devs = [mine[i % L] for i in range(world * L)]
    return Mesh(devs, (KEY_AXIS,), ranks=[i // L for i in range(world * L)])


def job_devices(device, n: int):
    """The devices of an engine mesh of ``n`` shards on ``device``: outside
    a multi-process job the list :func:`devices_for` draws from; inside
    one, the job's mesh (:func:`global_mesh`) with ``n / world`` shards a
    process, each on its own ``device`` (``"cuda"``: its cards)."""
    if not dist.is_available() or not dist.is_initialized():
        return devices_for(device, n)
    world = dist.get_world_size()
    if n % world:
        raise ValueError(
            f"mesh_devices={n} must be a multiple of the job's {world} "
            "processes (each holds as many shards)"
        )
    mine = devices_for(device, n // world)
    if len(mine) < n // world:
        raise ValueError(
            f"need {n // world} devices a process, have {len(mine)}"
        )
    return global_mesh(devices=mine[: n // world])
