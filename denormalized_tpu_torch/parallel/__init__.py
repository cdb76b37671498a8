"""Sharded window state: device meshes (``mesh``), the layouts
(``sharded_state``) and multi-process jobs (``distributed``)."""

from denormalized_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from denormalized_tpu_torch.parallel.sharded_state import (
    KeyShardedPartialMergeWindowState,
    KeyShardedWindowState,
    PartialFinalWindowState,
    TwoLevelWindowState,
    make_sharded_state,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "KeyShardedPartialMergeWindowState",
    "KeyShardedWindowState",
    "PartialFinalWindowState",
    "TwoLevelWindowState",
    "make_sharded_state",
]
