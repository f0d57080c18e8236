from overlapnet_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = ["batch_sharding", "make_mesh", "replicated", "shard_batch"]
