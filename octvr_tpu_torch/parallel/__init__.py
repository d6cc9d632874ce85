"""The band-sharded stitcher: ``S`` canvas bands with halos, all in one
process on one device (parallel/sharded.py)."""

from .sharded import BandMesh, LocalBands, ShardedMapper, ShardedPlan, build_sharded_plan, make_mesh

__all__ = ["BandMesh", "LocalBands", "ShardedMapper", "ShardedPlan", "build_sharded_plan", "make_mesh"]
