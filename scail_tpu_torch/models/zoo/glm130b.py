"""GLM-130B (counterpart of scail_tpu/models/zoo/glm130b.py): deepnorm
residuals on the layernormed input (alpha = (2L)^0.5), a GEGLU MLP (x1 ·
gelu(x2)), the 2D rotary (positions / block positions over the two halves
of the head dim) or a full-head 1D one, an f32 softmax at 1/sqrt(hd), the
LM head tied to the token table.  `glm130b_from_sat` reads the SAT GLM130B
names and takes the fused qkv from its per-head [q_h | k_h | v_h] blocks
to [q | k | v].
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_exact
from scail_tpu_torch.models.zoo.chatglm import (SAT_BLOCK, SAT_FINAL, SAT_LAYER, SatLayer,
                                                rope_2d)
from scail_tpu_torch.models.zoo.common import (LM, attend, mask_bias, neox_rope, norm, pick,
                                               stacked, table)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class GLM130BConfig:
    vocab_size: int = 150528
    dim: int = 12288
    num_heads: int = 96
    num_layers: int = 70
    inner_hidden_size: int = 32768
    position_encoding_2d: bool = True
    glu: bool = True
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class GLM130B(LM):
    def __init__(self, cfg: GLM130BConfig, device=None):
        super().__init__()
        self.config = cfg
        f = cfg.inner_hidden_size
        self.tok = table(cfg.vocab_size, cfg.dim, device)
        self.layers = nn.ModuleList(SatLayer(cfg.dim, f, 2 * f if cfg.glu else f, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = norm(cfg.dim, True, device)

    def forward(self, tokens, position_ids, mask=None):
        """tokens (b, s); position_ids (b, 2, s) under position_encoding_2d,
        else (b, s); mask an optional (b, s, s) 0/1.  Returns logits."""
        cfg = self.config
        n, hd = cfg.num_heads, cfg.head_dim
        alpha = (2 * cfg.num_layers) ** 0.5
        x = self.tok[tokens]
        bias = mask_bias(mask)
        for lp in self.layers:
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q, k, v = (t.unflatten(-1, (n, hd)) for t in
                       F.linear(y, lp.qkv.weight, lp.qkv.bias).chunk(3, dim=-1))
            if cfg.position_encoding_2d:
                q = rope_2d(q, position_ids[:, 0], position_ids[:, 1])
                k = rope_2d(k, position_ids[:, 0], position_ids[:, 1])
            else:
                q, k = neox_rope(q, position_ids, hd), neox_rope(k, position_ids, hd)
            o = attend(q * hd ** -0.5, k, v, bias=bias)
            x = y * alpha + F.linear(o, lp.dense.weight, lp.dense.bias)  # deepnorm
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            h = F.linear(y, lp.fc1.weight, lp.fc1.bias)
            if cfg.glu:
                h1, h2 = h.chunk(2, dim=-1)
                h = h1 * gelu_exact(h2)  # GEGLU
            else:
                h = gelu_exact(h)
            x = y * alpha + F.linear(h, lp.fc2.weight, lp.fc2.bias)
        x = layer_norm(x, self.final_ln.scale, self.final_ln.bias, eps=cfg.eps)
        return F.linear(x, self.tok)


def glm130b_from_sat(sd: Dict, cfg: GLM130BConfig) -> Dict[str, torch.Tensor]:
    """SAT GLM130B state dict -> `GLM130B.state_dict()` names."""
    n, hd = cfg.num_heads, cfg.head_dim
    out = pick(sd, SAT_FINAL)
    out.update(stacked(sd, cfg.num_layers, SAT_BLOCK, SAT_LAYER))
    for i in range(cfg.num_layers):
        for leaf in ("weight", "bias"):
            t = out[f"layers.{i}.qkv.{leaf}"]  # (3d[, in]) in per-head blocks
            t = t.reshape(n, 3, hd, *t.shape[1:]).transpose(0, 1)
            out[f"layers.{i}.qkv.{leaf}"] = t.reshape(3 * n * hd, *t.shape[3:])
    return out
