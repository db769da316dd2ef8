"""LLaMA-family decoder LM (counterpart of scail_tpu/models/zoo/llama.py):
RMSNorm pre-norm, rotary attention (HF's half rotation), GQA, a gated-SiLU
MLP, a tied or separate LM head; a KV cache for incremental decode and the
learned KV prefix of prefix tuning (training/prefix_tuning.py).

State-dict names mirror the JAX tree (`embed`, `layers.{i}.{ln1,q,k,v,o,ln2,
gate,up,down}`, `norm`, `lm_head`); `llama_from_hf` reads HF
`LlamaForCausalLM` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, KVCache, inv_freq, kv_attend, lin, norm,
                                               pick, stacked, table)
from scail_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    inner_hidden_size: int = 11008
    max_len: int = 2048
    rope_theta: float = 10000.0
    eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def head_dim(self):
        return self.dim // self.num_heads


def rope(x, positions, theta: float):
    """HF-llama rotary, halves rotated: x (b, s, n, hd), positions (s,)."""
    hd = x.shape[-1]
    ang = positions[:, None].float() * inv_freq(hd, theta, x.device)[None]
    cos = torch.cat([ang.cos()] * 2, -1)[None, :, None].to(x.dtype)
    sin = torch.cat([ang.sin()] * 2, -1)[None, :, None].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        d, kvd, f = cfg.dim, cfg.num_kv_heads * cfg.head_dim, cfg.inner_hidden_size
        self.ln1, self.ln2 = norm(d, device=device), norm(d, device=device)
        self.q, self.k, self.v = lin(d, d, device=device), lin(d, kvd, device=device), lin(
            d, kvd, device=device)
        self.o = lin(d, d, device=device)
        self.gate, self.up, self.down = lin(d, f, device=device), lin(d, f, device=device), lin(
            f, d, device=device)


class Llama(LM):
    layer_cls = LlamaLayer

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embed = table(cfg.vocab_size, cfg.dim, device)
        self.layers = nn.ModuleList(self.layer_cls(cfg, device) for _ in range(cfg.num_layers))
        self.norm = norm(cfg.dim, device=device)
        if not getattr(cfg, "tie_embeddings", False):
            self.lm_head = lin(cfg.dim, cfg.vocab_size, device=device)

    def new_cache(self, batch: int) -> KVCache:
        cfg = self.config
        return KVCache(cfg.num_layers, batch, cfg.max_len, cfg.num_kv_heads, cfg.head_dim,
                       device=self.embed.device, dtype=self.embed.dtype)

    def forward(self, tokens, cache: Optional[KVCache] = None, prefix=None, *, mlp=None):
        """tokens (b, s) -> (logits (b, s, vocab), cache).  `prefix`: an
        optional (L, 2, n_kv, P, hd) learned KV prefix, always visible.
        `mlp(layer, y)` replaces the gated-SiLU MLP (Mixtral's experts)."""
        cfg = self.config
        b, s = tokens.shape
        n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos0 = cache.length if cache is not None else 0
        positions = pos0 + torch.arange(s, device=tokens.device)
        x = self.embed[tokens]
        for li, lp in enumerate(self.layers):
            y = rms_norm(x, lp.ln1.scale, eps=cfg.eps)
            q = rope(F.linear(y, lp.q.weight).unflatten(-1, (n, hd)), positions, cfg.rope_theta)
            k = rope(F.linear(y, lp.k.weight).unflatten(-1, (nkv, hd)), positions, cfg.rope_theta)
            v = F.linear(y, lp.v.weight).unflatten(-1, (nkv, hd))
            o = kv_attend(q, k, v, cache, li, positions, scale=hd ** -0.5,
                          prefix=None if prefix is None else (prefix[li, 0], prefix[li, 1]))
            x = x + F.linear(o, lp.o.weight)
            y = rms_norm(x, lp.ln2.scale, eps=cfg.eps)
            if mlp is not None:
                x = x + mlp(lp, y)
            else:
                x = x + F.linear(F.silu(F.linear(y, lp.gate.weight)) * F.linear(y, lp.up.weight),
                                 lp.down.weight)
        x = rms_norm(x, self.norm.scale, eps=cfg.eps)
        head = self.embed if getattr(cfg, "tie_embeddings", False) else self.lm_head.weight
        if cache is not None:
            cache.length += s
        return F.linear(x, head), cache


def llama_from_hf(sd: Dict, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """HF LlamaForCausalLM state dict -> `Llama.state_dict()` names."""
    out = pick(sd, {"embed": "model.embed_tokens.weight", "norm.scale": "model.norm.weight"})
    out.update(stacked(sd, cfg.num_layers, {
        "ln1.scale": "input_layernorm.weight", "q.weight": "self_attn.q_proj.weight",
        "k.weight": "self_attn.k_proj.weight", "v.weight": "self_attn.v_proj.weight",
        "o.weight": "self_attn.o_proj.weight", "ln2.scale": "post_attention_layernorm.weight",
        "gate.weight": "mlp.gate_proj.weight", "up.weight": "mlp.up_proj.weight",
        "down.weight": "mlp.down_proj.weight"}, "model.layers.{}."))
    if not cfg.tie_embeddings:
        out.update(pick(sd, {"lm_head.weight": "lm_head.weight"}))
    return out
