"""Data and tensor parallelism over ``torch.distributed`` (the port of
``cvsd_tpu/parallel/``): meshes, batch sharding, process groups."""

from cvsd_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    batch_sharding,
    build_mesh,
    default_mesh_shape,
    replicated_sharding,
    shard_batch,
)
