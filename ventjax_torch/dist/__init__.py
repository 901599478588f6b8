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
    BatchSpaceMesh,
    Mesh,
    RankMesh,
    RankSpaceMesh,
    broadcast_one_to_all,
    initialize_multihost,
    local_devices,
    make_batch_mesh,
    make_batch_space_mesh,
    make_rank_mesh,
    make_rank_space_mesh,
    process_allgather,
    shard_cohort_fn,
    spatial_shard_fn,
)

__all__ = [
    "BatchSpaceMesh",
    "Mesh",
    "RankMesh",
    "RankSpaceMesh",
    "broadcast_one_to_all",
    "calculate_ci_sharded",
    "halo_width",
    "initialize_multihost",
    "local_devices",
    "make_batch_mesh",
    "make_batch_space_mesh",
    "make_rank_mesh",
    "make_rank_space_mesh",
    "make_sliced_ci_fn",
    "padded_depth_for",
    "process_allgather",
    "shard_cohort_fn",
    "spatial_shard_fn",
]
