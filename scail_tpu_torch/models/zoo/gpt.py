"""GPT-2-style decoder LM with a KV cache (counterpart of
scail_tpu/models/zoo/gpt.py): learned positions, pre-LN blocks, a fused qkv,
a GELU-tanh MLP, the LM head tied to the token table, optional bottleneck
adapters (training/adapters.py).  The full forward
serves training and prefill; with a cache each call appends its rows at the
cache's length (incremental decode).  `generate` prefills once and then
decodes one token a step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_tanh
from scail_tpu_torch.models.zoo.common import LM, KVCache, kv_attend, lin, norm, table
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.training.adapters import apply_adapter


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    max_len: int = 1024
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class GPTLayer(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d = cfg.dim
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.qkv, self.proj = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, 4 * d, True, device), lin(4 * d, d, True, device)


class GPT(LM):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.wte = table(cfg.vocab_size, cfg.dim, device)
        self.wpe = table(cfg.max_len, cfg.dim, device)
        self.layers = nn.ModuleList(GPTLayer(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = norm(cfg.dim, True, device)

    def new_cache(self, batch: int) -> KVCache:
        cfg = self.config
        return KVCache(cfg.num_layers, batch, cfg.max_len, cfg.num_heads, cfg.head_dim,
                       device=self.wte.device, dtype=self.wte.dtype)

    def forward(self, tokens, cache: Optional[KVCache] = None, prefix=None, adapters=None):
        """tokens (b, s) -> (logits, cache); `prefix` an optional (L, 2, n,
        P, hd) learned KV prefix, always visible; `adapters` an optional
        training/adapters.py `Adapters`, applied after each layer's attention
        output and after its MLP output."""
        cfg = self.config
        b, s = tokens.shape
        n, hd = cfg.num_heads, cfg.head_dim
        pos0 = cache.length if cache is not None else 0
        positions = pos0 + torch.arange(s, device=tokens.device)
        x = self.wte[tokens] + self.wpe[positions][None]
        for li, lp in enumerate(self.layers):
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q, k, v = (t.unflatten(-1, (n, hd)) for t in
                       F.linear(y, lp.qkv.weight, lp.qkv.bias).chunk(3, dim=-1))
            o = kv_attend(q, k, v, cache, li, positions, scale=hd ** -0.5,
                          prefix=None if prefix is None else (prefix[li, 0], prefix[li, 1]))
            attn_out = F.linear(o, lp.proj.weight, lp.proj.bias)
            if adapters is not None:
                attn_out = apply_adapter(adapters.layers[li].attn, attn_out)
            x = x + attn_out
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            mlp_out = F.linear(gelu_tanh(F.linear(y, lp.fc1.weight, lp.fc1.bias)), lp.fc2.weight,
                               lp.fc2.bias)
            if adapters is not None:
                mlp_out = apply_adapter(adapters.layers[li].mlp, mlp_out)
            x = x + mlp_out
        x = layer_norm(x, self.ln_f.scale, self.ln_f.bias, eps=cfg.eps)
        if cache is not None:
            cache.length += s
        return F.linear(x, self.wte), cache


@torch.no_grad()
def generate(model: GPT, prompt, max_new: int, generator: torch.Generator,
             temperature: float = 1.0, top_k: int = 0):
    """KV-cached generation: prefill the prompt (b, s0), then max_new - 1
    single-token decode steps; returns (b, s0 + max_new)."""
    from scail_tpu_torch.generation import BaseStrategy

    strategy = BaseStrategy(temperature=temperature, top_k=top_k)
    cache = model.new_cache(prompt.shape[0])
    logits, cache = model(prompt, cache)
    toks = [strategy.forward(logits[:, -1], generator)]
    for _ in range(max_new - 1):
        logits, cache = model(toks[-1][:, None], cache)
        toks.append(strategy.forward(logits[:, -1], generator))
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
