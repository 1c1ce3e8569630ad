"""The camera batch split over devices (parallel/mesh.py)."""

from doomtpu_torch.parallel.mesh import (  # noqa: F401
    SplitEngine, SplitState, make_mesh, replicate, shard_batch,
)
