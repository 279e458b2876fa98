from nngparareal_torch.parallel.mesh import (
    SLICE_AXIS,
    Mesh,
    make_mesh,
    shard_fine_fanout,
    slice_sharding,
)

__all__ = ["SLICE_AXIS", "Mesh", "make_mesh", "shard_fine_fanout",
           "slice_sharding"]
