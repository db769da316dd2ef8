"""ChatGLM2 / ChatGLM3 decoder LMs (counterpart of
scail_tpu/models/zoo/chatglm23.py): RMSNorm pre-norm, a fused qkv with
multi-query kv heads ([q | k | v] along the output, q n·hd wide, k and v
n_kv·hd), qkv bias, the interleaved rotary on the first half of the head
dim (base 10000 · base_scale), a SwiGLU MLP with its gate from SAT's
SwiGLUMixin (v2: silu(fc1 x) · gate x; v3, `swap_swiglu`: silu(gate x) ·
fc1 x), an untied LM head, a KV cache.  `chatglm2_from_sat` reads the SAT
ChatGLM2Model / ChatGLM3Model names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, KVCache, attend, interleaved_rope, lin, norm,
                                               pick, table)
from scail_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class ChatGLM2Config:
    vocab_size: int = 65024
    dim: int = 4096
    num_heads: int = 32
    num_kv_heads: int = 2
    num_layers: int = 28
    inner_hidden_size: int = 13696
    max_len: int = 2048
    eps: float = 1e-5
    base_scale: float = 1.0
    swap_swiglu: bool = False
    qkv_bias: bool = True
    use_bias: bool = False

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def rotary_dim(self):
        return self.head_dim // 2


def chatglm3_config(**kw) -> ChatGLM2Config:
    """ChatGLM3: the v2 substrate with the SwiGLU operands swapped."""
    kw.setdefault("swap_swiglu", True)
    return ChatGLM2Config(**kw)


class ChatGLM2Layer(nn.Module):
    def __init__(self, cfg: ChatGLM2Config, device=None):
        super().__init__()
        d, hd, f, ub = cfg.dim, cfg.head_dim, cfg.inner_hidden_size, cfg.use_bias
        self.ln1, self.ln2 = norm(d, device=device), norm(d, device=device)
        self.qkv = lin(d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, ub or cfg.qkv_bias, device)
        self.dense = lin(cfg.num_heads * hd, d, ub, device)
        self.fc1, self.gate = lin(d, f, ub, device), lin(d, f, ub, device)
        self.fc2 = lin(f, d, ub, device)


def _lin(layer, x):
    return F.linear(x, layer.weight, layer.bias)


class ChatGLM2(LM):
    def __init__(self, cfg: ChatGLM2Config, device=None):
        super().__init__()
        self.config = cfg
        self.tok = table(cfg.vocab_size, cfg.dim, device)
        self.layers = nn.ModuleList(ChatGLM2Layer(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = norm(cfg.dim, device=device)
        self.lm_head = lin(cfg.dim, cfg.vocab_size, device=device)

    def new_cache(self, batch: int) -> KVCache:
        cfg = self.config
        return KVCache(cfg.num_layers, batch, cfg.max_len, cfg.num_kv_heads, cfg.head_dim,
                       device=self.tok.device, dtype=self.tok.dtype)

    def forward(self, tokens, position_ids=None, mask=None, cache: Optional[KVCache] = None):
        """tokens (b, s) -> (logits, cache).  position_ids (b, s) default to
        the positions; mask an optional (b, s, s) 0/1 padding mask ANDed with
        the causal one (without a cache)."""
        cfg = self.config
        b, s = tokens.shape
        n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos0 = cache.length if cache is not None else 0
        rows = pos0 + torch.arange(s, device=tokens.device)
        if position_ids is None:
            position_ids = rows[None].expand(b, s)
        theta = 10000.0 * cfg.base_scale
        x = self.tok[tokens]
        for li, lp in enumerate(self.layers):
            y = rms_norm(x, lp.ln1.scale, eps=cfg.eps)
            q, k, v = _lin(lp.qkv, y).split([n * hd, nkv * hd, nkv * hd], dim=-1)
            q = interleaved_rope(q.unflatten(-1, (n, hd)), position_ids, cfg.rotary_dim, theta)
            k = interleaved_rope(k.unflatten(-1, (nkv, hd)), position_ids, cfg.rotary_dim, theta)
            v = v.unflatten(-1, (nkv, hd))
            if cache is not None:
                k, v = cache.update(li, k, v)
            valid = (torch.arange(k.shape[1], device=x.device)[None] <= rows[:, None])[None]
            if cache is None and mask is not None:
                valid = valid & (mask > 0)
            o = attend(q, k, v, valid=valid[:, None], scale=hd ** -0.5)
            x = x + _lin(lp.dense, o)
            y = rms_norm(x, lp.ln2.scale, eps=cfg.eps)
            x1, x2 = _lin(lp.fc1, y), _lin(lp.gate, y)
            h = F.silu(x2) * x1 if cfg.swap_swiglu else F.silu(x1) * x2
            x = x + _lin(lp.fc2, h)
        x = rms_norm(x, self.final_ln.scale, eps=cfg.eps)
        if cache is not None:
            cache.length += s
        return F.linear(x, self.lm_head.weight), cache


def chatglm2_from_sat(sd: Dict, cfg: ChatGLM2Config) -> Dict[str, torch.Tensor]:
    """SAT ChatGLM2Model / ChatGLM3Model state dict -> `ChatGLM2.state_dict()`
    names (the SwiGLU gate from "mixins.mlp.w2.{i}"; a bias where the file
    has one)."""
    out = pick(sd, {"tok": "transformer.word_embeddings.weight",
                    "final_ln.scale": "transformer.final_layernorm.weight",
                    "lm_head.weight": "mixins.chatglm-final.lm_head.weight"})
    t = "transformer.layers.{}."
    srcs = {"qkv": t + "attention.query_key_value", "dense": t + "attention.dense",
            "fc1": t + "mlp.dense_h_to_4h", "gate": "mixins.mlp.w2.{}",
            "fc2": t + "mlp.dense_4h_to_h"}
    for i in range(cfg.num_layers):
        out[f"layers.{i}.ln1.scale"] = torch.as_tensor(sd[t.format(i) + "input_layernorm.weight"])
        out[f"layers.{i}.ln2.scale"] = torch.as_tensor(
            sd[t.format(i) + "post_attention_layernorm.weight"])
        for dst, src in srcs.items():
            for leaf in ("weight", "bias"):
                key = f"{src.format(i)}.{leaf}"
                if leaf == "weight" or key in sd:
                    out[f"layers.{i}.{dst}.{leaf}"] = torch.as_tensor(sd[key])
    return out
