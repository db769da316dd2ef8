"""ChatGLM v1 (counterpart of scail_tpu/models/zoo/chatglm.py): post-LN
blocks with deepnorm's alpha = (2L)^0.5 scaling of the layernormed
residual, the 2D rotary (half of the head dim rotated by the positions, half
by the block positions, GPT-NeoX tables per token), a GELU MLP, an untied
biasless LM head.  `chatglm_from_sat` reads the SAT ChatGLMModel names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_exact
from scail_tpu_torch.models.zoo.common import (LM, attend, lin, mask_bias, neox_rope, norm,
                                               pick, stacked, table)
from scail_tpu_torch.ops.norms import layer_norm

SAT_LAYER = "transformer.layers.{}."
SAT_BLOCK = {"ln1.scale": "input_layernorm.weight", "ln1.bias": "input_layernorm.bias",
             "qkv.weight": "attention.query_key_value.weight",
             "qkv.bias": "attention.query_key_value.bias",
             "dense.weight": "attention.dense.weight", "dense.bias": "attention.dense.bias",
             "ln2.scale": "post_attention_layernorm.weight",
             "ln2.bias": "post_attention_layernorm.bias",
             "fc1.weight": "mlp.dense_h_to_4h.weight", "fc1.bias": "mlp.dense_h_to_4h.bias",
             "fc2.weight": "mlp.dense_4h_to_h.weight", "fc2.bias": "mlp.dense_4h_to_h.bias"}
SAT_FINAL = {"tok": "transformer.word_embeddings.weight",
             "final_ln.scale": "transformer.final_layernorm.weight",
             "final_ln.bias": "transformer.final_layernorm.bias"}


@dataclasses.dataclass(frozen=True)
class ChatGLMConfig:
    vocab_size: int = 130528
    dim: int = 4096
    num_heads: int = 32
    num_layers: int = 28
    inner_hidden_size: int = 16384
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class SatLayer(nn.Module):
    """The SAT block's parameters: ln1, qkv, dense, ln2, fc1 (d -> fc1_out),
    fc2 (inner -> d), all with biases."""

    def __init__(self, d: int, inner: int, fc1_out: int, device=None):
        super().__init__()
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.qkv, self.dense = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, fc1_out, True, device), lin(inner, d, True, device)


def rope_2d(x, pos_ids, block_ids):
    """Half 1 of the head dim rotated by pos_ids, half 2 by block_ids."""
    x1, x2 = x.chunk(2, dim=-1)
    half = x.shape[-1] // 2
    return torch.cat([neox_rope(x1, pos_ids, half), neox_rope(x2, block_ids, half)], dim=-1)


class ChatGLM(LM):
    def __init__(self, cfg: ChatGLMConfig, device=None):
        super().__init__()
        self.config = cfg
        self.tok = table(cfg.vocab_size, cfg.dim, device)
        self.layers = nn.ModuleList(SatLayer(cfg.dim, cfg.inner_hidden_size,
                                             cfg.inner_hidden_size, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = norm(cfg.dim, True, device)
        self.lm_head = lin(cfg.dim, cfg.vocab_size, device=device)

    def forward(self, tokens, position_ids, mask=None):
        """tokens (b, s); position_ids (b, 2, s) = [positions; block
        positions]; mask an optional (b, s, s) 0/1.  Returns logits."""
        cfg = self.config
        n, hd = cfg.num_heads, cfg.head_dim
        alpha = (2 * cfg.num_layers) ** 0.5
        x = self.tok[tokens]
        bias = mask_bias(mask)
        for lp in self.layers:
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q, k, v = (t.unflatten(-1, (n, hd)) for t in
                       F.linear(y, lp.qkv.weight, lp.qkv.bias).chunk(3, dim=-1))
            q = rope_2d(q, position_ids[:, 0], position_ids[:, 1])
            k = rope_2d(k, position_ids[:, 0], position_ids[:, 1])
            o = attend(q * hd ** -0.5, k, v, bias=bias)
            x = y * alpha + F.linear(o, lp.dense.weight, lp.dense.bias)  # deepnorm residual
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            h = F.linear(gelu_exact(F.linear(y, lp.fc1.weight, lp.fc1.bias)), lp.fc2.weight,
                         lp.fc2.bias)
            x = y * alpha + h
        x = layer_norm(x, self.final_ln.scale, self.final_ln.bias, eps=cfg.eps)
        return F.linear(x, self.lm_head.weight)


def chatglm_from_sat(sd: Dict, cfg: ChatGLMConfig) -> Dict[str, torch.Tensor]:
    """SAT ChatGLMModel state dict -> `ChatGLM.state_dict()` names."""
    out = pick(sd, dict(SAT_FINAL, **{"lm_head.weight": "mixins.chatglm-final.lm_head.weight"}))
    out.update(stacked(sd, cfg.num_layers, SAT_BLOCK, SAT_LAYER))
    return out
