"""Meshes and sharded CI: the port of ``ventjax/dist``.

torch.distributed is imported inside the functions that use it.
"""
from ventjax_torch.dist.halo import (
    calculate_ci_sharded,
    halo_width,
    make_sliced_ci_fn,
    padded_depth_for,
)
from ventjax_torch.dist.mesh import (
    Mesh,
    RankMesh,
    initialize_multihost,
    local_devices,
    make_batch_mesh,
    make_rank_mesh,
    shard_cohort_fn,
)

__all__ = [
    "Mesh",
    "RankMesh",
    "calculate_ci_sharded",
    "halo_width",
    "initialize_multihost",
    "local_devices",
    "make_batch_mesh",
    "make_rank_mesh",
    "make_sliced_ci_fn",
    "padded_depth_for",
    "shard_cohort_fn",
]
