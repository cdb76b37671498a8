"""Device meshes — counterpart of ``denormalized_tpu/parallel/mesh.py``.

The JAX package's scale-out axis is a ``jax.sharding.Mesh``: the mesh axis
``"keys"`` plays the hash-partition axis (group-state shards one a device,
rows reaching the right shard by masking a replicated batch) and, on a 2-D
mesh, the axis ``"slices"`` splits rows data-parallel.  One process drives
every device there through ``shard_map``.

In the port a :class:`Mesh` is a plain object array of ``torch.device``s
with the same axis names, and each ring shard is a set of torch tensors on
its device (``parallel/sharded_state.py``).  A device may appear more than
once: several shards can sit on one card (or on the CPU), so every layout
runs on a single H100.  In a multi-process job (``parallel/distributed.py``)
the mesh also records which process owns each position; a process holds
only its own shards.
"""

from __future__ import annotations

import numpy as np
import torch

KEY_AXIS = "keys"
# second axis of the 2-D layout: data-parallel row slices (keys sharded
# within a slice, slices merged only at emission)
SLICE_AXIS = "slices"


class Mesh:
    """An n-D array of devices with named axes — the fields of the JAX
    ``Mesh`` the layouts read: ``devices`` (an object array, so
    ``.devices.size`` and ``.devices.flat`` work), ``axis_names`` and
    ``shape[axis]``.  ``ranks`` is None in a one-process job, else an int
    array of the same shape naming the process that owns each position."""

    def __init__(self, devices, axis_names: tuple[str, ...], ranks=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"{arr.ndim}-D devices for axes {tuple(axis_names)}"
            )
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=int)
        if self.ranks is not None and self.ranks.shape != arr.shape:
            raise ValueError(
                f"ranks {self.ranks.shape} do not match devices {arr.shape}"
            )

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks.flat)) > 1

    def is_local(self, flat_index: int) -> bool:
        """Whether this process holds the shard at ``flat_index``."""
        if self.ranks is None:
            return True
        import torch.distributed as dist

        return int(self.ranks.flat[flat_index]) == dist.get_rank()

    def __repr__(self) -> str:
        return (
            f"Mesh({dict(self.shape)}, "
            f"devices={[str(d) for d in self.devices.flat]})"
        )


def default_devices() -> list[torch.device]:
    """Every visible card, in index order (none without CUDA): the
    counterpart of ``jax.devices()``.  A CPU mesh names its devices."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for(device: torch.device | str, n: int) -> list[torch.device]:
    """The device list a mesh of ``n`` shards draws from, by the engine's
    ``device``: ``"cuda"`` without an index means every visible card (so
    asking for more shards than cards raises, as in the JAX package); one
    named device (``"cuda:0"``, ``"cpu"``) holds every shard."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return default_devices()
    return [dev] * n


def make_mesh_2d(
    n_slices: int, n_key_shards: int | None = None, devices=None
) -> Mesh:
    """2-D mesh ``(slices, keys)``: rows are data-parallel across the slice
    axis, group state is sharded across the key axis (innermost, so a
    slice's key shards are adjacent devices).  ``devices`` may be a 1-D
    mesh, such as a multi-process job's ``global_mesh()``: its owners carry
    over."""
    ranks = None
    if isinstance(devices, Mesh):
        ranks, devices = devices.ranks, list(devices.devices.flat)
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if n_key_shards is None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices not divisible by {n_slices} slices"
            )
        n_key_shards = len(devices) // n_slices
    need = n_slices * n_key_shards
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices ({n_slices}x{n_key_shards}), have "
            f"{len(devices)}"
        )
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    shape = (n_slices, n_key_shards)
    return Mesh(arr.reshape(shape), (SLICE_AXIS, KEY_AXIS),
                ranks=None if ranks is None else ranks.ravel()[:need].reshape(shape))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh (axis "keys") over ``devices`` (default: every visible
    card), truncated to the first ``n_devices``.  In a multi-process job do
    NOT truncate — use
    :func:`denormalized_tpu_torch.parallel.distributed.global_mesh`."""
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                f"({[torch.device(d).type for d in devices[:3]]}...)"
            )
        devices = devices[:n_devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, (KEY_AXIS,))
