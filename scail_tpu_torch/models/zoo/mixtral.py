"""Mixtral sparse-MoE decoder LM (counterpart of
scail_tpu/models/zoo/mixtral.py): the LLaMA attention stack of zoo/llama.py
with the top-k mixture of gated-SiLU experts of ops/moe.py in place of the
MLP.  `mixtral_from_hf` reads HF `MixtralForCausalLM` names;
`mixtral_param_rules` shards the experts over 'model' (expert parallelism),
and `forward(mesh=...)` then runs this rank's experts and all-reduces their
sum over the model ranks, as the MoE DiT does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import experts, lin, norm, pick, stacked
from scail_tpu_torch.models.zoo.llama import Llama
from scail_tpu_torch.ops.moe import moe_mlp
from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS
from scail_tpu_torch.parallel.sharding import PathRules, Rule


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    inner_hidden_size: int = 14336
    num_experts: int = 8
    top_k: int = 2
    max_len: int = 4096
    rope_theta: float = 1e6
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class MixtralLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        d, kvd = cfg.dim, cfg.num_kv_heads * cfg.head_dim
        E, f = cfg.num_experts, cfg.inner_hidden_size
        self.ln1, self.ln2 = norm(d, device=device), norm(d, device=device)
        self.q, self.k, self.v = lin(d, d, device=device), lin(d, kvd, device=device), lin(
            d, kvd, device=device)
        self.o = lin(d, d, device=device)
        self.moe_gate = lin(d, E, device=device)
        self.moe_w1 = experts(E, f, d, device)  # gate proj (the SiLU side)
        self.moe_w3 = experts(E, f, d, device)  # up proj
        self.moe_w2 = experts(E, d, f, device)  # down proj


class Mixtral(Llama):
    layer_cls = MixtralLayer

    def forward(self, tokens, mesh=None):
        """tokens (b, s) -> logits (b, s, vocab).  Under a 'model' mesh each
        rank holds its slice of the experts (`mixtral_param_rules`)."""
        cfg = self.config
        tp = mesh is not None and mesh.size(MODEL_AXIS) > 1

        def moe(lp, y):
            gate, offset = lp.moe_gate.weight, 0
            if tp:
                y = comm.copy_to(y, mesh, MODEL_AXIS)
                gate = comm.copy_to(gate, mesh, MODEL_AXIS)
                offset = mesh.rank(MODEL_AXIS) * lp.moe_w1.weight.shape[0]
            out = moe_mlp(y, gate, lp.moe_w3.weight, lp.moe_w2.weight, top_k=cfg.top_k,
                          act=F.silu, w_gate=lp.moe_w1.weight, expert_offset=offset)
            return comm.reduce_from(out, mesh, MODEL_AXIS) if tp else out

        return super().forward(tokens, mlp=moe)[0]


def mixtral_from_hf(sd: Dict, cfg: MixtralConfig) -> Dict[str, torch.Tensor]:
    """HF MixtralForCausalLM state dict -> `Mixtral.state_dict()` names
    (each expert's w1 / w2 / w3 stacked on the expert axis)."""
    out = pick(sd, {"embed": "model.embed_tokens.weight", "norm.scale": "model.norm.weight",
                    "lm_head.weight": "lm_head.weight"})
    out.update(stacked(sd, cfg.num_layers, {
        "ln1.scale": "input_layernorm.weight", "q.weight": "self_attn.q_proj.weight",
        "k.weight": "self_attn.k_proj.weight", "v.weight": "self_attn.v_proj.weight",
        "o.weight": "self_attn.o_proj.weight", "ln2.scale": "post_attention_layernorm.weight",
        "moe_gate.weight": "block_sparse_moe.gate.weight"}, "model.layers.{}."))
    for i in range(cfg.num_layers):
        for w in ("w1", "w2", "w3"):
            out[f"layers.{i}.moe_{w}.weight"] = torch.stack([torch.as_tensor(
                sd[f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"])
                for e in range(cfg.num_experts)])
    return out


def mixtral_param_rules() -> PathRules:
    """Expert parallelism: whole experts over 'model' (JAX
    mixtral_param_rules); the rest replicated."""
    return PathRules([Rule(r"layers\.\d+\.(moe_w1|moe_w2|moe_w3)\.weight$", (MODEL_AXIS,))])
