"""Distribution, port of revisiting_at_tpu/parallel: process groups and the
mesh (mesh.py), tensor parallelism (tp.py), the gradient sync, FSDP shards
and full checkpoint tensors of one rank's model (zero.py), the
differentiable collectives of the split blocks (collectives.py) and a
launcher of local ranks (launch.py)."""

from .mesh import (DistInfo, Mesh, MeshConfig, batch_shard, fsdp_dim, init_distributed,
                   make_mesh)

__all__ = ["DistInfo", "Mesh", "MeshConfig", "batch_shard", "fsdp_dim", "init_distributed",
           "make_mesh"]
