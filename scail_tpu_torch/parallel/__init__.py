"""Parallelism over torch.distributed (counterpart of scail_tpu/parallel/):
the data x seq x model rank mesh, the explicit collectives with their
gradients and their counts (`COLLECTIVES`), sharding rules over state_dict
names, Ulysses and ring attention and vocab-parallel cross entropy."""

from scail_tpu_torch.parallel.comm import (COLLECTIVE_BYTES, COLLECTIVES,
                                           reset_collective_counts)
from scail_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, MeshSpec,
                                           get_mesh, make_mesh, mesh_axis_size, set_mesh)
from scail_tpu_torch.parallel.ring import ring_attention
from scail_tpu_torch.parallel.sharding import (PathRules, gather_state_dict, shard_state_dict,
                                               specs_for_state_dict)

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshSpec",
    "make_mesh",
    "get_mesh",
    "set_mesh",
    "mesh_axis_size",
    "ring_attention",
    "PathRules",
    "specs_for_state_dict",
    "shard_state_dict",
    "gather_state_dict",
    "COLLECTIVES",
    "COLLECTIVE_BYTES",
    "reset_collective_counts",
]
