"""Replica-consistency checks (counterpart of scail_tpu/training/sync.py:1-52;
reference: sat/training/deepspeed_training.py:218-296 `check_param_sync` /
`sync_params_across_ranks`, sgm/util.py:95-122 `check_value_sync`).

Under JAX SPMD a replicated parameter is one logical array; here each rank
holds its own copy, so copies can drift (a missed gradient reduce, a
divergent load).  The copies of a parameter are those of the ranks that
hold the same slice of it: for a tensor sharded over the mesh's 'model'
axis (its rule in `rules` names that axis), the ranks of the replica axis
(data x seq, parallel/mesh.py `REPLICA_AXIS`); for a replicated tensor,
every rank.  Drift is the elementwise max over those ranks minus the min,
reduced by comm.all_reduce_, and its largest entry.  Without a mesh (one
process) there is one copy: drift 0.0, and syncing is a no-op.
"""

from __future__ import annotations

from typing import Dict

import torch

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS, REPLICA_AXIS


def _axes(name: str, t: torch.Tensor, rules) -> tuple:
    """The mesh axes over which `t`'s copies are spread."""
    rule = rules.rule_for(name, t.dim()) if rules is not None else None
    if rule is not None and MODEL_AXIS in rule.spec:
        return (REPLICA_AXIS,)
    return (REPLICA_AXIS, MODEL_AXIS)


def _live(mesh) -> bool:
    return mesh is not None and not mesh.trivial


def check_value_sync(x: torch.Tensor, name: str = "tensor", atol: float = 0.0, mesh=None,
                     axes=(REPLICA_AXIS, MODEL_AXIS)) -> float:
    """The largest elementwise max - min of x over the ranks of `axes`
    (sgm/util.py:95-122); raises AssertionError when it is above atol."""
    if not _live(mesh) or x.numel() == 0:
        return 0.0
    hi = x.detach().float().clone()
    lo = hi.clone()
    for axis in axes:
        comm.all_reduce_(hi, mesh, axis, "max")
        comm.all_reduce_(lo, mesh, axis, "min")
    drift = float((hi - lo).max())
    if drift > atol:
        raise AssertionError(f"{name}: replica drift {drift} > {atol}")
    return drift


def check_param_sync(params: Dict[str, torch.Tensor], atol: float = 0.0, mesh=None,
                     rules=None) -> float:
    """The largest replica drift over every tensor of `params` (a name ->
    tensor dict, this rank's slices), sharded ones compared over the
    replica axis and replicated ones over every rank
    (deepspeed_training.py:245-296)."""
    drift = 0.0
    for name, t in params.items():
        drift = max(drift, check_value_sync(t, name, atol, mesh, _axes(name, t, rules)))
    return drift


def sync_params_across_ranks(params: Dict[str, torch.Tensor], mesh=None,
                             rules=None) -> Dict[str, torch.Tensor]:
    """Overwrite every copy with the one of the first rank of its replica
    group (and, for a replicated tensor, of the first model rank), in place
    (deepspeed_training.py:218-243); a no-op when the copies agree."""
    if not _live(mesh):
        return params
    with torch.no_grad():
        for name, t in params.items():
            for axis in _axes(name, t, rules):
                comm.broadcast_(t.data, mesh, axis, src=0)
    return params
