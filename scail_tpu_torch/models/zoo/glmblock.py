"""The original GLM with 2D block positions (counterpart of
scail_tpu/models/zoo/glmblock.py): a pre-LN SAT transformer whose input
adds two learned position tables (positions and block positions), a GELU
MLP, the LM head tied to the token table.  `glmblock_from_sat` reads the
SAT GLMModel names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_exact
from scail_tpu_torch.models.zoo.chatglm import SAT_BLOCK, SAT_FINAL, SAT_LAYER, SatLayer
from scail_tpu_torch.models.zoo.common import LM, attend, mask_bias, norm, pick, stacked, table
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class GLMBlockConfig:
    vocab_size: int = 30592
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    inner_hidden_size: int = 4096
    max_len: int = 1025
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class GLMBlock(LM):
    def __init__(self, cfg: GLMBlockConfig, device=None):
        super().__init__()
        self.config = cfg
        f = cfg.inner_hidden_size
        self.tok = table(cfg.vocab_size, cfg.dim, device)
        self.pos = table(cfg.max_len, cfg.dim, device)
        self.block_pos = table(cfg.max_len, cfg.dim, device)
        self.layers = nn.ModuleList(SatLayer(cfg.dim, f, f, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = norm(cfg.dim, True, device)

    def forward(self, tokens, position_ids, mask=None):
        """tokens (b, s); position_ids (b, 2, s) = [positions; block
        positions]; mask an optional (b, s, s) 0/1 (None: full attention).
        Returns logits."""
        cfg = self.config
        n, hd = cfg.num_heads, cfg.head_dim
        x = self.tok[tokens] + self.pos[position_ids[:, 0]] + self.block_pos[position_ids[:, 1]]
        bias = mask_bias(mask)
        for lp in self.layers:
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q, k, v = (t.unflatten(-1, (n, hd)) for t in
                       F.linear(y, lp.qkv.weight, lp.qkv.bias).chunk(3, dim=-1))
            o = attend(q * hd ** -0.5, k, v, bias=bias)
            x = x + F.linear(o, lp.dense.weight, lp.dense.bias)
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            x = x + F.linear(gelu_exact(F.linear(y, lp.fc1.weight, lp.fc1.bias)), lp.fc2.weight,
                             lp.fc2.bias)
        x = layer_norm(x, self.final_ln.scale, self.final_ln.bias, eps=cfg.eps)
        return F.linear(x, self.tok)


def glmblock_from_sat(sd: Dict, cfg: GLMBlockConfig) -> Dict[str, torch.Tensor]:
    """SAT GLMModel state dict -> `GLMBlock.state_dict()` names."""
    out = pick(sd, dict(SAT_FINAL, pos="transformer.position_embeddings.weight",
                        block_pos="mixins.block_position_embedding."
                                  "block_position_embeddings.weight"))
    out.update(stacked(sd, cfg.num_layers, SAT_BLOCK, SAT_LAYER))
    return out
