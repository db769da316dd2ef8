"""CogView's cuda2d two-level super-resolution LM (counterpart of
scail_tpu/models/zoo/cuda2d.py).

The sequence is [text + level-0 image tokens (layout[1]) | level-1 image
tokens (layout[2] - layout[1])].  Each layer runs dense masked attention
over level 0 with the base qkv (the reference's `scores · mask - 10000 · (1
- mask)`), and 2D local attention for level 1 with its own qkv_plus: a
causal (2k - 1, k) window over its l1 x l1 grid and a non-causal k2 x k2
window over the last l0² level-0 tokens, one softmax over [cross, self]
(ops/local_attn_2d.py); the two levels are projected by dense / dense_plus
and concatenated.  Positions come from the base table for level 0 and from
the extra table for level 1.  `cuda2d_from_sat` reads the SAT Cuda2dModel
names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_tanh
from scail_tpu_torch.models.zoo.chatglm import SAT_BLOCK, SAT_FINAL, SAT_LAYER
from scail_tpu_torch.models.zoo.common import LM, attend, lin, norm, pick, stacked, table
from scail_tpu_torch.ops.local_attn_2d import f_similar, f_weighting
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class Cuda2dConfig:
    vocab_size: int = 50048
    dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    max_len: int = 1089
    new_sequence_length: int = 5185
    layout: Tuple[int, int, int] = (64, 1088, 5184)
    kernel_size: int = 9
    kernel_size2: int = 7
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def l0(self):
        return int(math.isqrt(self.layout[1] - self.layout[0]))

    @property
    def l1(self):
        return int(math.isqrt(self.layout[2] - self.layout[1]))


class Cuda2dLayer(nn.Module):
    def __init__(self, cfg: Cuda2dConfig, device=None):
        super().__init__()
        d = cfg.dim
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.qkv, self.dense = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.qkv_plus, self.dense_plus = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, 4 * d, True, device), lin(4 * d, d, True, device)


def _to_grid(x, side):
    """(b, s, n, hd) in raster order -> (b·n, hd, side, side)."""
    b, s, n, hd = x.shape
    return x.permute(0, 2, 3, 1).reshape(b * n, hd, side, side)


def sparse_attention_2d(q0, k0, v0, q1, k1, v1, mask, cfg: Cuda2dConfig):
    """The reference's sparse_attention_2d_light on (b, s, n, hd) tensors:
    (context0 (b, s0, d), context1 (b, s1, d))."""
    b, s0, n, hd = q0.shape
    s1 = q1.shape[1]
    l0, l1, k, k2 = cfg.l0, cfg.l1, cfg.kernel_size, cfg.kernel_size2
    scale = 1.0 / math.sqrt(hd)
    m = mask[:, None].float()
    logits0 = torch.einsum("bqnd,bknd->bnqk", (q0 * scale).float(), k0.float())
    probs0 = torch.softmax(logits0 * m - 10000.0 * (1.0 - m), dim=-1).to(v0.dtype)
    ctx0 = torch.einsum("bnqk,bknd->bqnd", probs0, v0).reshape(b, s0, n * hd)

    q1g, k1g, v1g = _to_grid(q1 * scale, l1), _to_grid(k1, l1), _to_grid(v1, l1)
    k0g, v0g = _to_grid(k0[:, -l0 * l0:], l0), _to_grid(v0[:, -l0 * l0:], l0)
    s_self = f_similar(q1g, k1g, 2 * k - 1, k, causal=True)
    s_cross = f_similar(q1g, k0g, k2, k2, causal=False)
    fc = s_cross.shape[-1]
    probs1 = torch.softmax(torch.cat([s_cross, s_self], dim=-1), dim=-1)
    ctx1 = (f_weighting(v1g, probs1[..., fc:], 2 * k - 1, k, causal=True)
            + f_weighting(v0g, probs1[..., :fc], k2, k2, causal=False))
    return ctx0, ctx1.reshape(b, n * hd, s1).transpose(1, 2)


class Cuda2d(LM):
    def __init__(self, cfg: Cuda2dConfig, device=None):
        super().__init__()
        self.config = cfg
        self.tok = table(cfg.vocab_size, cfg.dim, device)
        self.pos = table(cfg.max_len, cfg.dim, device)
        self.pos_plus = table(cfg.new_sequence_length - cfg.max_len, cfg.dim, device)
        self.layers = nn.ModuleList(Cuda2dLayer(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = norm(cfg.dim, True, device)

    def forward(self, tokens, position_ids, mask):
        """tokens, position_ids (b, layout[2]); mask (b, s0, s0) 0/1 over
        level 0.  Returns logits (b, s, vocab) on the tied table."""
        cfg = self.config
        b, s = tokens.shape
        s0, n, hd = cfg.layout[1], cfg.num_heads, cfg.head_dim
        x = self.tok[tokens] + torch.cat([self.pos[position_ids[:, :s0]],
                                          self.pos_plus[position_ids[:, s0:]]], dim=1)
        for lp in self.layers:
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q0, k0, v0 = (t.unflatten(-1, (n, hd)) for t in F.linear(
                y[:, :s0], lp.qkv.weight, lp.qkv.bias).chunk(3, dim=-1))
            q1, k1, v1 = (t.unflatten(-1, (n, hd)) for t in F.linear(
                y[:, s0:], lp.qkv_plus.weight, lp.qkv_plus.bias).chunk(3, dim=-1))
            ctx0, ctx1 = sparse_attention_2d(q0, k0, v0, q1, k1, v1, mask, cfg)
            x = x + torch.cat([F.linear(ctx0, lp.dense.weight, lp.dense.bias),
                               F.linear(ctx1, lp.dense_plus.weight, lp.dense_plus.bias)], dim=1)
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            x = x + F.linear(gelu_tanh(F.linear(y, lp.fc1.weight, lp.fc1.bias)), lp.fc2.weight,
                             lp.fc2.bias)
        x = layer_norm(x, self.ln_f.scale, self.ln_f.bias, eps=cfg.eps)
        return F.linear(x, self.tok)


def cuda2d_from_sat(sd: Dict, cfg: Cuda2dConfig) -> Dict[str, torch.Tensor]:
    """SAT Cuda2dModel state dict (base transformer + the
    'extra_position_embedding' and 'attention_plus' mixins) ->
    `Cuda2d.state_dict()` names."""
    final = {("ln_f" + k[len("final_ln"):] if k.startswith("final_ln") else k): v
             for k, v in SAT_FINAL.items()}
    out = pick(sd, dict(final, pos="transformer.position_embeddings.weight",
                        pos_plus="mixins.extra_position_embedding.position_embeddings.weight"))
    plus = {"qkv_plus.weight": "/mixins.attention_plus.query_key_value.{}.weight",
            "qkv_plus.bias": "/mixins.attention_plus.query_key_value.{}.bias",
            "dense_plus.weight": "/mixins.attention_plus.dense.{}.weight",
            "dense_plus.bias": "/mixins.attention_plus.dense.{}.bias"}
    out.update(stacked(sd, cfg.num_layers, dict(SAT_BLOCK, **plus), SAT_LAYER))
    return out
