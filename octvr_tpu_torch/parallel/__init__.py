"""The band-sharded stitcher: ``S`` canvas bands with halos, in one
process or spread over the ranks of a torch.distributed mesh
(parallel/sharded.py)."""

from .sharded import (
    BandMesh,
    DistributedBands,
    LocalBands,
    ShardedMapper,
    ShardedPlan,
    build_sharded_plan,
    make_mesh,
)

__all__ = [
    "BandMesh",
    "DistributedBands",
    "LocalBands",
    "ShardedMapper",
    "ShardedPlan",
    "build_sharded_plan",
    "make_mesh",
]
