"""EVA-02 masked-image-modelling encoder (counterpart of
scail_tpu/models/zoo/eva2.py): the patch embedding with mask-token
substitution, learned absolute positions, a 2-D vision rotary on the patch
tokens (the cls token passes), a SwiGLU MLP with a LayerNorm on its gated
hidden, a final LayerNorm and a feature head over the patch tokens.

The rotary tables are the JAX numpy f32 tables; they multiply q and k in
f32 (JAX promotes bf16 q, k against them), so q and k enter the logits in
f32.  That is not K10 (`ops/fused_norms.py` `apply_rotary_fused`, tables
rounded to bf16), which this model does not use.

State-dict names mirror the JAX tree (`patch_embed`, `mask_token`, `cls`,
`pos`, `layers.{i}.{ln1,qkv,dense,ln2,w1,w2,ffn_ln,w3}`, `final_ln`, `head`);
`eva2_from_sat` reads the SAT EVA2Model names.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import parameter
from scail_tpu_torch.models.zoo.common import (LM, dense, lin, norm, patch_conv, patchify,
                                               pick, sat_linears, table)
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.ops.rotary import rotate_half


@dataclasses.dataclass(frozen=True)
class EVA2Config:
    image_size: int = 224
    patch_size: int = 14
    in_channels: int = 3
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    inner_hidden_size: int = 2048
    predict_feature_dim: int = 768
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def grid(self):
        return self.image_size // self.patch_size


@lru_cache(maxsize=8)
def vision_rope_tables(head_dim: int, grid: int):
    """VisionRotaryEmbeddingFast's cos, sin (grid², head_dim), numpy f32:
    per-axis interleaved frequencies of length head_dim / 2 each, the h axis
    then the w axis."""
    dim = head_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    t = np.arange(grid, dtype=np.float32)
    ang = np.repeat(np.outer(t, freqs), 2, axis=-1)
    full = np.concatenate([np.broadcast_to(ang[:, None, :], (grid, grid, dim)),
                           np.broadcast_to(ang[None, :, :], (grid, grid, dim))],
                          axis=-1).reshape(grid * grid, 2 * dim)
    return np.cos(full), np.sin(full)


def _rope_patches(x, cos, sin):
    """The rotary on tokens 1: of (b, s, n, hd) x in f32; token 0 passes."""
    rest = x[:, 1:] * cos + rotate_half(x[:, 1:], True) * sin
    return torch.cat([x[:, :1].float(), rest], dim=1)


class EVA2Layer(nn.Module):
    def __init__(self, cfg: EVA2Config, device=None):
        super().__init__()
        d, f = cfg.dim, cfg.inner_hidden_size
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.qkv, self.dense = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.w1, self.w2 = lin(d, f, True, device), lin(d, f, True, device)
        self.ffn_ln = norm(f, True, device)
        self.w3 = lin(f, d, True, device)


class EVA2(LM):
    def __init__(self, cfg: EVA2Config, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.dim
        self.patch_embed = patch_conv(cfg.in_channels, d, cfg.patch_size, device)
        self.mask_token = parameter(d, device=device)
        self.cls = table(1, d, device)
        self.pos = table(cfg.grid ** 2 + 1, d, device)
        self.layers = nn.ModuleList(EVA2Layer(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = norm(d, True, device)
        self.head = lin(d, cfg.predict_feature_dim, True, device)

    def forward(self, images, bool_masked_pos=None):
        """images (b, C, H, W) -> predicted features (b, num_patches,
        predict_feature_dim); bool_masked_pos (b, num_patches) puts the mask
        token in place of those patches."""
        cfg = self.config
        n, hd = cfg.num_heads, cfg.head_dim
        x = patchify(self.patch_embed, images, cfg.patch_size)
        b = x.shape[0]
        if bool_masked_pos is not None:
            w = bool_masked_pos[..., None].to(x.dtype)
            x = x * (1 - w) + self.mask_token[None, None] * w
        x = torch.cat([self.cls[None].expand(b, 1, cfg.dim), x], dim=1) + self.pos[None]
        cos, sin = (torch.from_numpy(t).to(x.device)[None, :, None, :]
                    for t in vision_rope_tables(hd, cfg.grid))
        for p in self.layers:
            y = layer_norm(x, p.ln1.scale, p.ln1.bias, eps=cfg.eps)
            q, k, v = (t.unflatten(-1, (n, hd)) for t in dense(y, p.qkv).chunk(3, dim=-1))
            q, k = _rope_patches(q, cos, sin), _rope_patches(k, cos, sin)
            s = torch.einsum("bqnd,bknd->bnqk", q * hd ** -0.5, k)
            o = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s, dim=-1).to(v.dtype), v)
            x = x + dense(o.reshape(b, -1, cfg.dim), p.dense)
            y = layer_norm(x, p.ln2.scale, p.ln2.bias, eps=cfg.eps)
            h = F.silu(dense(y, p.w1)) * dense(y, p.w2)
            h = layer_norm(h, p.ffn_ln.scale, p.ffn_ln.bias, eps=cfg.eps)
            x = x + dense(h, p.w3)
        x = layer_norm(x, self.final_ln.scale, self.final_ln.bias, eps=cfg.eps)
        return dense(x[:, 1:], self.head)


def eva2_from_sat(sd: Dict, cfg: EVA2Config) -> Dict[str, torch.Tensor]:
    """The reference EVA2Model (SAT) state dict -> `EVA2.state_dict()` names."""
    out = pick(sd, {"patch_embed.weight": "mixins.patch_embedding.proj.weight",
                    "patch_embed.bias": "mixins.patch_embedding.proj.bias",
                    "pos": "transformer.position_embeddings.weight",
                    "final_ln.scale": "transformer.final_layernorm.weight",
                    "final_ln.bias": "transformer.final_layernorm.bias",
                    "head.weight": "mixins.eva2-final.lm_head.weight",
                    "head.bias": "mixins.eva2-final.lm_head.bias"})
    out["mask_token"] = torch.as_tensor(sd["mixins.patch_embedding.mask_token"])[0, 0]
    out["cls"] = torch.as_tensor(sd["transformer.word_embeddings.weight"])[:1]
    out.update(sat_linears(sd, cfg.num_layers, {
        "ln1": "input_layernorm", "qkv": "attention.query_key_value",
        "dense": "attention.dense", "ln2": "post_attention_layernorm",
        "w1": "mlp.dense_h_to_4h", "w2": "/mixins.eva2-mlp.w2.{}",
        "ffn_ln": "/mixins.eva2-mlp.ffn_ln.{}", "w3": "mlp.dense_4h_to_h"},
        "transformer.layers.{}.", norms=("ln1", "ln2", "ffn_ln")))
    return out
