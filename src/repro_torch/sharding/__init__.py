"""Bank sharding: a 1-D device mesh over the reference bank's K axis and
the tensors split over it (see :mod:`repro_torch.sharding.mesh`)."""

from .mesh import (BankMesh, NamedSharding, PartitionSpec, ShardedTensor,
                   canonical_device, make_mesh, mesh_layout, shard_tensor)

__all__ = ["BankMesh", "make_mesh", "mesh_layout", "canonical_device",
           "PartitionSpec", "NamedSharding", "ShardedTensor",
           "shard_tensor"]
