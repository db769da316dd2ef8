"""EVA2-CLIP vision tower (counterpart of scail_tpu/models/zoo/evaclip.py):
a ViT whose blocks normalise each sublayer's output before the residual add
(x + LN(attn(x)), then x + LN(mlp(x)), exact GELU), cls + patches with
learned positions, a final LayerNorm, and the patch tokens out (cls dropped).

State-dict names mirror the JAX tree (`patch_embed`, `cls`, `pos`,
`layers.{i}.{qkv,dense,ln1,fc1,fc2,ln2}`, `final_ln`); `evaclip_from_sat`
reads the SAT EVA2CLIPModel names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, attend, dense, lin, norm, patch_conv,
                                               patchify, pick, sat_linears, table)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class EVACLIPConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    inner_hidden_size: int = 4096
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class EVACLIPLayer(nn.Module):
    def __init__(self, cfg: EVACLIPConfig, device=None):
        super().__init__()
        d, f = cfg.dim, cfg.inner_hidden_size
        self.qkv, self.dense = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)


class EVACLIP(LM):
    def __init__(self, cfg: EVACLIPConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.dim
        self.patch_embed = patch_conv(cfg.in_channels, d, cfg.patch_size, device)
        self.cls = table(1, d, device)
        self.pos = table((cfg.image_size // cfg.patch_size) ** 2 + 1, d, device)
        self.layers = nn.ModuleList(EVACLIPLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln = norm(d, True, device)

    def forward(self, images):
        """images (b, C, H, W) -> patch hidden states (b, num_patches, d)."""
        cfg = self.config
        n, hd = cfg.num_heads, cfg.head_dim
        x = patchify(self.patch_embed, images, cfg.patch_size)
        b = x.shape[0]
        x = torch.cat([self.cls[None].expand(b, 1, cfg.dim), x], dim=1) + self.pos[None]
        for p in self.layers:
            q, k, v = (t.unflatten(-1, (n, hd)) for t in dense(x, p.qkv).chunk(3, dim=-1))
            o = attend(q * hd ** -0.5, k, v)
            x = x + layer_norm(dense(o, p.dense), p.ln1.scale, p.ln1.bias, eps=cfg.eps)
            h = dense(F.gelu(dense(x, p.fc1)), p.fc2)
            x = x + layer_norm(h, p.ln2.scale, p.ln2.bias, eps=cfg.eps)
        x = layer_norm(x, self.final_ln.scale, self.final_ln.bias, eps=cfg.eps)
        return x[:, 1:]


def evaclip_from_sat(sd: Dict, cfg: EVACLIPConfig) -> Dict[str, torch.Tensor]:
    """The reference EVA2CLIPModel (SAT) state dict -> `EVACLIP.state_dict()`
    names."""
    out = pick(sd, {"patch_embed.weight": "mixins.patch_embedding.proj.weight",
                    "patch_embed.bias": "mixins.patch_embedding.proj.bias",
                    "pos": "transformer.position_embeddings.weight",
                    "final_ln.scale": "transformer.final_layernorm.weight",
                    "final_ln.bias": "transformer.final_layernorm.bias"})
    out["cls"] = torch.as_tensor(sd["transformer.word_embeddings.weight"])[:1]
    out.update(sat_linears(sd, cfg.num_layers, {
        "qkv": "attention.query_key_value", "dense": "attention.dense",
        "ln1": "input_layernorm", "fc1": "mlp.dense_h_to_4h", "fc2": "mlp.dense_4h_to_h",
        "ln2": "post_attention_layernorm"}, "transformer.layers.{}.", norms=("ln1", "ln2")))
    return out
