"""ViT image classifier (counterpart of scail_tpu/models/zoo/vit.py): the
patch convolution, a cls token and learned positions, pre-LN blocks, the
final LayerNorm and a linear head on the cls token.

State-dict names mirror the JAX tree (`patch_embed`, `cls_token` (1, d),
`pos_embed`, `layers.{i}.*` (`ViTLayer`), `ln_f`, `head`); the patch kernel
is PyTorch's (d, 3, p, p), where the JAX tree holds HWIO.  `vit_from_hf`
reads HF `ViTForImageClassification` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, ViTLayer, dense, hf_vit_layers, lin,
                                               norm, patch_conv, patchify, pick, table,
                                               vit_block)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    inner_hidden_size: int = 3072
    num_classes: int = 1000
    eps: float = 1e-12

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class ViT(LM):
    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.dim
        self.patch_embed = patch_conv(3, d, cfg.patch_size, device)
        self.cls_token = table(1, d, device)
        self.pos_embed = table((cfg.image_size // cfg.patch_size) ** 2 + 1, d, device)
        self.layers = nn.ModuleList(ViTLayer(d, cfg.inner_hidden_size, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = norm(d, True, device)
        self.head = lin(d, cfg.num_classes, True, device)

    def forward(self, images):
        """images (b, 3, H, W), normalized -> logits (b, num_classes)."""
        cfg = self.config
        x = patchify(self.patch_embed, images, cfg.patch_size)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, cfg.dim), x], dim=1)
        x = x + self.pos_embed[None]
        for lp in self.layers:
            x = vit_block(x, lp, cfg.num_heads, cfg.eps)
        x = layer_norm(x, self.ln_f.scale, self.ln_f.bias, eps=cfg.eps)
        return dense(x[:, 0], self.head)


def vit_from_hf(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """HF ViTForImageClassification state dict -> `ViT.state_dict()` names."""
    e = "vit.embeddings."
    out = pick(sd, {"patch_embed.weight": e + "patch_embeddings.projection.weight",
                    "patch_embed.bias": e + "patch_embeddings.projection.bias",
                    "ln_f.scale": "vit.layernorm.weight", "ln_f.bias": "vit.layernorm.bias",
                    "head.weight": "classifier.weight", "head.bias": "classifier.bias"})
    out["cls_token"] = torch.as_tensor(sd[e + "cls_token"])[0]
    out["pos_embed"] = torch.as_tensor(sd[e + "position_embeddings"])[0]
    out.update(hf_vit_layers(sd, cfg.num_layers, "vit.encoder.layer.{}."))
    return out
