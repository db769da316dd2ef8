"""The rank mesh (counterpart of scail_tpu/parallel/mesh.py).

The JAX package lays its devices out as one ('data', 'seq', 'model') Mesh and
lets XLA insert the collectives.  Here each rank is one process that holds
only its shard, and every collective is an explicit call over one of the
mesh's process groups (parallel/comm.py).  Ranks are laid out
data x seq x model with `model` fastest, as `make_mesh` reshapes the devices
in the JAX package and as the reference lays out its model-parallel ranks
(sat/mpu/initialize.py:101): rank = (d * seq + s) * model + m.

The groups come from torch.distributed.device_mesh.init_device_mesh with the
dim names 'data', 'seq' and 'model'; `make_mesh` adds the group of the ranks
that share this rank's model coordinate (data x seq), the axis 'replica',
over which the trainer sums the gradients.  Without a process group (one
process) the only mesh is the trivial one, which issues no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

DATA_AXIS = "data"    # batch sharding
SEQ_AXIS = "seq"      # sequence sharding (Ulysses, ring, context-parallel VAE)
MODEL_AXIS = "model"  # tensor parallel (column / row-parallel linears)

AXIS_NAMES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
# the ranks that share this rank's model coordinate (data x seq): a group of
# its own, not a dim of the DeviceMesh
REPLICA_AXIS = "replica"

_GLOBAL_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """World layout data x seq x model (the reference's
    initialize_model_parallel(model_parallel_size, sequence_parallel_size))."""

    data: int = 1
    seq: int = 1
    model: int = 1

    @property
    def world(self) -> int:
        return self.data * self.seq * self.model

    @staticmethod
    def infer(n_ranks: int, seq: int = 1, model: int = 1) -> "MeshSpec":
        if n_ranks % (seq * model):
            raise ValueError(f"world size {n_ranks} must be divisible by seq*model="
                             f"{seq * model} (reference assert: sat/mpu/initialize.py:89-90)")
        return MeshSpec(data=n_ranks // (seq * model), seq=seq, model=model)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A MeshSpec and, when it spans more than one rank, the DeviceMesh whose
    groups carry its collectives.  `size`, `rank` and `coords` answer for
    this process; a Mesh made without a DeviceMesh is the single-process view
    of the spec (rank 0 on every axis), which shape checks may take but no
    collective can run on."""

    spec: MeshSpec
    device_mesh: object = None
    # the group of the ranks that share this rank's model coordinate
    replica_group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self.spec, a) for a in AXIS_NAMES}

    def size(self, axis: str) -> int:
        if axis == REPLICA_AXIS:
            return self.spec.data * self.spec.seq
        return getattr(self.spec, axis)

    def rank(self, axis: str) -> int:
        """This process's coordinate on `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def coords(self) -> Dict[str, int]:
        return {a: self.rank(a) for a in AXIS_NAMES}

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError(f"mesh {self.spec} has no process groups: the {axis!r} "
                               "collective needs make_mesh under torch.distributed")
        if axis == REPLICA_AXIS:
            return self.replica_group
        return self.device_mesh.get_group(axis)

    @property
    def trivial(self) -> bool:
        return self.spec.world == 1


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(spec: MeshSpec = None, *, seq: int = 1, model: int = 1) -> Mesh:
    """The data x seq x model mesh over the initialised process group (or the
    trivial one without it).  The spec's world must equal the group's size.
    DeviceMesh's device type is 'cuda' under NCCL and 'cpu' under gloo
    (whose groups carry CUDA tensors too)."""
    world = _world()
    if spec is None:
        spec = MeshSpec.infer(world, seq=seq, model=model)
    if spec.world != world:
        raise RuntimeError(f"mesh spec {spec} needs {spec.world} ranks but the world has "
                           f"{world}: launch one process per rank with RANK / WORLD_SIZE / "
                           "MASTER_ADDR / MASTER_PORT and --distributed")
    if not dist.is_initialized():
        return Mesh(spec)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (spec.data, spec.seq, spec.model),
                          mesh_dim_names=AXIS_NAMES)
    # every rank creates every replica group, in the same order
    me = dist.get_rank()
    replica = None
    for m in range(spec.model):
        ranks = [r for r in range(spec.world) if r % spec.model == m]
        g = dist.new_group(ranks)
        if me in ranks:
            replica = g
    return Mesh(spec, dm, replica)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> Mesh:
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = make_mesh()
    return _GLOBAL_MESH


def mesh_axis_size(axis: str, mesh: Mesh = None) -> int:
    return (mesh or get_mesh()).size(axis)
