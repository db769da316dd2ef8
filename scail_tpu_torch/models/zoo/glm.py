"""GLM-4 decoder LM (counterpart of scail_tpu/models/zoo/glm.py): RMSNorm
pre-norm, GQA (2 kv heads at 9B) with qkv bias, the interleaved rotary on
the first half of the head dim, a SwiGLU MLP with a fused gate+up
projection, a KV cache.  `glm_from_hf` reads HF `GlmForCausalLM` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, KVCache, interleaved_rope, kv_attend, lin,
                                               norm, pick, stacked, table)
from scail_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class GlmConfig:
    vocab_size: int = 151552
    dim: int = 4096
    num_layers: int = 40
    num_heads: int = 32
    num_kv_heads: int = 2
    head_dim: int = 128
    inner_hidden_size: int = 13696
    max_len: int = 2048
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.5
    eps: float = 1.5625e-07
    tie_embeddings: bool = False

    @property
    def rotary_dim(self):
        return int(self.head_dim * self.partial_rotary_factor)


class GlmLayer(nn.Module):
    def __init__(self, cfg: GlmConfig, device=None):
        super().__init__()
        d, hd, f = cfg.dim, cfg.head_dim, cfg.inner_hidden_size
        qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.ln1, self.ln2 = norm(d, device=device), norm(d, device=device)
        self.q, self.k, self.v = (lin(d, qd, True, device), lin(d, kvd, True, device),
                                  lin(d, kvd, True, device))
        self.o = lin(qd, d, device=device)
        self.gate_up, self.down = lin(d, 2 * f, device=device), lin(f, d, device=device)


class Glm(LM):
    def __init__(self, cfg: GlmConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embed = table(cfg.vocab_size, cfg.dim, device)
        self.layers = nn.ModuleList(GlmLayer(cfg, device) for _ in range(cfg.num_layers))
        self.norm = norm(cfg.dim, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = lin(cfg.dim, cfg.vocab_size, device=device)

    def new_cache(self, batch: int) -> KVCache:
        cfg = self.config
        return KVCache(cfg.num_layers, batch, cfg.max_len, cfg.num_kv_heads, cfg.head_dim,
                       device=self.embed.device, dtype=self.embed.dtype)

    def forward(self, tokens, cache: Optional[KVCache] = None, inputs_embeds=None):
        """tokens (b, s) -> (logits, cache); `inputs_embeds` (b, s, d)
        replaces the token embedding."""
        cfg = self.config
        b, s = tokens.shape
        n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos0 = cache.length if cache is not None else 0
        positions = pos0 + torch.arange(s, device=tokens.device)
        x = self.embed[tokens] if inputs_embeds is None else inputs_embeds
        for li, lp in enumerate(self.layers):
            y = rms_norm(x, lp.ln1.scale, eps=cfg.eps)
            q, k, v = (F.linear(y, w.weight, w.bias).unflatten(-1, (h, hd))
                       for w, h in ((lp.q, n), (lp.k, nkv), (lp.v, nkv)))
            q = interleaved_rope(q, positions, cfg.rotary_dim, cfg.rope_theta)
            k = interleaved_rope(k, positions, cfg.rotary_dim, cfg.rope_theta)
            o = kv_attend(q, k, v, cache, li, positions, scale=hd ** -0.5)
            x = x + F.linear(o, lp.o.weight)
            y = rms_norm(x, lp.ln2.scale, eps=cfg.eps)
            gate, up = F.linear(y, lp.gate_up.weight).chunk(2, dim=-1)
            x = x + F.linear(up * F.silu(gate), lp.down.weight)
        x = rms_norm(x, self.norm.scale, eps=cfg.eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head.weight
        if cache is not None:
            cache.length += s
        return F.linear(x, head), cache


def glm_from_hf(sd: Dict, cfg: GlmConfig) -> Dict[str, torch.Tensor]:
    """HF GlmForCausalLM state dict -> `Glm.state_dict()` names."""
    out = pick(sd, {"embed": "model.embed_tokens.weight", "norm.scale": "model.norm.weight"})
    a = "self_attn."
    out.update(stacked(sd, cfg.num_layers, {
        "ln1.scale": "input_layernorm.weight", "q.weight": a + "q_proj.weight",
        "q.bias": a + "q_proj.bias", "k.weight": a + "k_proj.weight", "k.bias": a + "k_proj.bias",
        "v.weight": a + "v_proj.weight", "v.bias": a + "v_proj.bias",
        "o.weight": a + "o_proj.weight", "ln2.scale": "post_attention_layernorm.weight",
        "gate_up.weight": "mlp.gate_up_proj.weight", "down.weight": "mlp.down_proj.weight"},
        "model.layers.{}."))
    if not cfg.tie_embeddings:
        out.update(pick(sd, {"lm_head.weight": "lm_head.weight"}))
    return out
