"""Device meshes, the tensors split over them, and the sharding rules:
a 1-D mesh over the reference bank's K axis, a (data, model) mesh for
the MoE layer's experts and the sharded train step (its data rows'
sub-meshes, :meth:`BankMesh.data_row`; see
:mod:`repro_torch.sharding.mesh`), and the parameter, optimizer-moment,
batch and cache spec maps and the activation callback
(:mod:`repro_torch.sharding.rules`)."""

from .mesh import (BankMesh, NamedSharding, PartitionSpec, ShardedTensor,
                   canonical_device, make_mesh, mesh_layout, shard_tensor)

__all__ = ["BankMesh", "make_mesh", "mesh_layout", "canonical_device",
           "PartitionSpec", "NamedSharding", "ShardedTensor",
           "shard_tensor"]
