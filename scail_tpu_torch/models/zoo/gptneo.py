"""GPT-Neo decoder LM (counterpart of scail_tpu/models/zoo/gptneo.py):
pre-LN GPT with learned positions, alternating global and local
(sliding-window) causal attention with unscaled f32 logits, a GELU-tanh MLP
and the LM head tied to the token table.  `gptneo_from_hf` reads HF
`GPTNeoForCausalLM` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import gelu_tanh
from scail_tpu_torch.models.zoo.common import LM, attend, lin, norm, pick, stacked, table
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig:
    vocab_size: int = 50257
    dim: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    inner_hidden_size: int = 8192
    max_len: int = 2048
    window_size: int = 256
    attention_pattern: Tuple[str, ...] = ("global", "local")
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    def layer_type(self, li: int) -> str:
        return self.attention_pattern[li % len(self.attention_pattern)]


class GPTNeoLayer(nn.Module):
    def __init__(self, cfg: GPTNeoConfig, device=None):
        super().__init__()
        d, f = cfg.dim, cfg.inner_hidden_size
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.q, self.k, self.v = (lin(d, d, device=device) for _ in range(3))
        self.o = lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)


class GPTNeo(LM):
    def __init__(self, cfg: GPTNeoConfig, device=None):
        super().__init__()
        self.config = cfg
        self.wte = table(cfg.vocab_size, cfg.dim, device)
        self.wpe = table(cfg.max_len, cfg.dim, device)
        self.layers = nn.ModuleList(GPTNeoLayer(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = norm(cfg.dim, True, device)

    def forward(self, tokens):
        """tokens (b, s) -> logits (b, s, vocab)."""
        cfg = self.config
        b, s = tokens.shape
        n, hd = cfg.num_heads, cfg.head_dim
        pos = torch.arange(s, device=tokens.device)
        x = self.wte[tokens] + self.wpe[pos][None]
        causal = pos[None] <= pos[:, None]
        local = causal & (pos[None] > pos[:, None] - cfg.window_size)
        zero = torch.zeros((), device=x.device)
        bias = {"global": torch.where(causal, zero, -1e9), "local": torch.where(local, zero, -1e9)}
        for li, lp in enumerate(self.layers):
            y = layer_norm(x, lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            q, k, v = (F.linear(y, w.weight).unflatten(-1, (n, hd)) for w in (lp.q, lp.k, lp.v))
            o = attend(q, k, v, bias=bias[cfg.layer_type(li)])  # unscaled logits
            x = x + F.linear(o, lp.o.weight, lp.o.bias)
            y = layer_norm(x, lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
            x = x + F.linear(gelu_tanh(F.linear(y, lp.fc1.weight, lp.fc1.bias)), lp.fc2.weight,
                             lp.fc2.bias)
        x = layer_norm(x, self.ln_f.scale, self.ln_f.bias, eps=cfg.eps)
        return F.linear(x, self.wte)


def gptneo_from_hf(sd: Dict, cfg: GPTNeoConfig) -> Dict[str, torch.Tensor]:
    """HF GPTNeoForCausalLM state dict -> `GPTNeo.state_dict()` names."""
    out = pick(sd, {"wte": "transformer.wte.weight", "wpe": "transformer.wpe.weight",
                    "ln_f.scale": "transformer.ln_f.weight", "ln_f.bias": "transformer.ln_f.bias"})
    a = "attn.attention."
    out.update(stacked(sd, cfg.num_layers, {
        "ln1.scale": "ln_1.weight", "ln1.bias": "ln_1.bias", "q.weight": a + "q_proj.weight",
        "k.weight": a + "k_proj.weight", "v.weight": a + "v_proj.weight",
        "o.weight": a + "out_proj.weight", "o.bias": a + "out_proj.bias",
        "ln2.scale": "ln_2.weight", "ln2.bias": "ln_2.bias", "fc1.weight": "mlp.c_fc.weight",
        "fc1.bias": "mlp.c_fc.bias", "fc2.weight": "mlp.c_proj.weight",
        "fc2.bias": "mlp.c_proj.bias"}, "transformer.h.{}."))
    return out
