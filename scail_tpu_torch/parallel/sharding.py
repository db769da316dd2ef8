"""Parameter sharding rules over state_dict names (counterpart of
scail_tpu/parallel/sharding.py and of dit_param_rules,
scail_tpu/models/dit.py:280-293).

A spec is a tuple with one entry per dimension of the tensor: None
(replicated) or a mesh axis name (sharded over it), as a JAX PartitionSpec
over the same dimensions.  The port's linears hold their weight as
nn.Linear's (out, in), so a column-parallel weight shards dimension 0 and a
row-parallel one dimension 1.

Fused projections: qkv is [q | k | v] along its output dimension, cross_kv
and clip_kv are [k | v].  JAX shards the fused column range of the global
array and its later split is still right; here a rank must hold its heads of
q, of k and of v, so the shard of a fused weight is `parts` strided slices
(one per part), not one contiguous range.  `Rule.parts` says how many.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str
    spec: Tuple[Optional[str], ...]
    parts: int = 1  # fused projections: equal parts along the sharded dimension


class PathRules:
    """Ordered (regex -> spec) rules over '.'-joined state_dict names; the
    first match wins and no match means replicated."""

    def __init__(self, rules: List[Rule]):
        self.rules = [(re.compile(r.pattern), r) for r in rules]

    def rule_for(self, name: str, ndim: int) -> Optional[Rule]:
        for pat, rule in self.rules:
            if pat.search(name):
                if len(rule.spec) > ndim:
                    raise ValueError(f"rule {pat.pattern} spec {rule.spec} has more dims than "
                                     f"the value ({ndim}) at {name}")
                return rule
        return None

    def spec_for(self, name: str, ndim: int) -> Tuple[Optional[str], ...]:
        rule = self.rule_for(name, ndim)
        return rule.spec if rule is not None else ()


def dit_param_rules() -> PathRules:
    """Tensor parallel over 'model': column-parallel qkv, cross_q, cross_kv,
    clip_kv and mlp_in (weight and bias), row-parallel attn_out, cross_out and
    mlp_out (weight; the bias is added once, after the reduce); the MoE
    experts (moe_in, moe_out, weight and bias) whole over 'model'.  The
    optional (head|tail)_layers segment matches the JAX package's
    save_attn_frac layout."""
    seg = r"layers\.(?:(?:head|tail)_layers\.)?\d+\."
    col = {"qkv": 3, "cross_kv": 2, "clip_kv": 2, "cross_q": 1, "mlp_in": 1}
    rules = []
    for name, parts in col.items():
        rules.append(Rule(seg + name + r"\.weight$", (MODEL_AXIS, None), parts))
        rules.append(Rule(seg + name + r"\.bias$", (MODEL_AXIS,), parts))
    rules.append(Rule(seg + r"(attn_out|cross_out|mlp_out)\.weight$", (None, MODEL_AXIS)))
    # expert parallelism: whole experts over 'model' (JAX dit.py:288-292)
    rules.append(Rule(seg + r"(moe_in|moe_out)\.(weight|bias)$", (MODEL_AXIS,)))
    return PathRules(rules)


def specs_for_state_dict(sd: Dict[str, torch.Tensor], rules: PathRules):
    return {n: rules.spec_for(n, t.dim()) for n, t in sd.items()}


def _sharded_dim(rule: Optional[Rule]):
    if rule is None:
        return None, None
    for dim, axis in enumerate(rule.spec):
        if axis is not None:
            return dim, axis
    return None, None


def shard_tensor(t: torch.Tensor, rule: Optional[Rule], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full tensor under `rule` (a view)."""
    dim, axis = _sharded_dim(rule)
    if dim is None or mesh.size(axis) == 1:
        return t
    p, r = mesh.size(axis), mesh.rank(axis)
    if t.shape[dim] % (rule.parts * p):
        raise ValueError(f"{rule.pattern}: dim {dim} of {tuple(t.shape)} does not divide into "
                         f"{rule.parts} parts over {p} {axis!r} ranks")
    pieces = t.chunk(rule.parts, dim=dim)
    n = pieces[0].shape[dim] // p
    local = [piece.narrow(dim, r * n, n) for piece in pieces]
    return local[0] if len(local) == 1 else torch.cat(local, dim=dim)


def gather_tensor(t: torch.Tensor, rule: Optional[Rule], mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's slice (a collective over the rule's
    axis; every rank of it must call)."""
    dim, axis = _sharded_dim(rule)
    if dim is None or mesh.size(axis) == 1:
        return t
    p = mesh.size(axis)
    whole = comm.all_gather(t.contiguous(), mesh, axis, dim)  # rank-major [r0 | r1 | ...]
    # each rank's slice is [part0 | part1 | ...]: regroup by part
    ranks = whole.chunk(p, dim=dim)
    parts = [r.chunk(rule.parts, dim=dim) for r in ranks]
    return torch.cat([parts[r][k] for k in range(rule.parts) for r in range(p)], dim=dim)


def shard_state_dict(full: Dict[str, torch.Tensor], rules: PathRules,
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of every tensor of a full state dict."""
    return {n: shard_tensor(t, rules.rule_for(n, t.dim()), mesh) for n, t in full.items()}


def gather_state_dict(local: Dict[str, torch.Tensor], rules: PathRules,
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's slices (every rank calls, in the
    same name order, and gets the whole dict)."""
    return {n: gather_tensor(t, rules.rule_for(n, t.dim()), mesh) for n, t in local.items()}


def shard_module_(module: torch.nn.Module, rules: PathRules, mesh: Mesh) -> torch.nn.Module:
    """Replace every parameter a rule shards by this rank's slice (a copy, so
    the full tensor can be freed), keeping its requires_grad."""
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            for leaf, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                local = shard_tensor(p, rules.rule_for(name, p.dim()), mesh)
                if local is not p:
                    mod._parameters[leaf] = torch.nn.Parameter(
                        local.contiguous().clone(), requires_grad=p.requires_grad)
    return module
