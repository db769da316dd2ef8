"""Masked-autoencoder ViT (counterpart of scail_tpu/models/zoo/mae.py):
per-sample random masking from a given noise (a stable argsort, so ties
order as `jnp.argsort` orders them), the ViT encoder on the kept patches,
a decoder that puts mask tokens back in place by `ids_restore`, and the
loss: the per-patch mean squared error over the removed patches only,
optionally against per-patch normalised pixels.

State-dict names mirror the JAX tree (`patch_embed`, `cls_token` (1, d),
`pos_embed`, `layers.{i}.*` (`ViTLayer`), `norm`, `decoder.{embed,mask_token,
pos_embed,layers.{i}.*,norm,pred}`); `mae_from_hf` reads HF
`ViTMAEForPreTraining` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from scail_tpu_torch.models.common import container, parameter
from scail_tpu_torch.models.zoo.common import (LM, ViTLayer, dense, hf_vit_layers, lin,
                                               norm, patch_conv, patchify, pick, table,
                                               vit_block)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    inner_hidden_size: int = 3072
    decoder_dim: int = 512
    decoder_num_heads: int = 16
    decoder_num_layers: int = 8
    decoder_inner_hidden_size: int = 2048
    mask_ratio: float = 0.75
    eps: float = 1e-12

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


def random_masking(x, noise, mask_ratio: float):
    """x (b, N, d), noise (b, N) -> (kept (b, len_keep, d), mask (b, N) with
    1 = removed, ids_restore (b, N))."""
    b, N, d = x.shape
    len_keep = int(N * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    kept = torch.gather(x, 1, ids_shuffle[:, :len_keep, None].expand(-1, -1, d))
    mask = torch.ones(b, N, device=x.device)
    mask[:, :len_keep] = 0.0
    return kept, torch.gather(mask, 1, ids_restore), ids_restore


class MAE(LM):
    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d, dd, N = cfg.dim, cfg.decoder_dim, cfg.num_patches
        self.patch_embed = patch_conv(cfg.num_channels, d, cfg.patch_size, device)
        self.cls_token = table(1, d, device)
        self.pos_embed = table(N + 1, d, device)
        self.layers = nn.ModuleList(ViTLayer(d, cfg.inner_hidden_size, device)
                                    for _ in range(cfg.num_layers))
        self.norm = norm(d, True, device)
        self.decoder = container(
            embed=lin(d, dd, True, device), mask_token=parameter(dd, device=device),
            pos_embed=table(N + 1, dd, device),
            layers=nn.ModuleList(ViTLayer(dd, cfg.decoder_inner_hidden_size, device)
                                 for _ in range(cfg.decoder_num_layers)),
            norm=norm(dd, True, device),
            pred=lin(dd, cfg.patch_size ** 2 * cfg.num_channels, True, device))

    def encode(self, images, noise):
        """images (b, C, H, W), noise (b, num_patches) in [0, 1) -> (latent
        (b, 1 + len_keep, d), mask, ids_restore)."""
        cfg = self.config
        x = patchify(self.patch_embed, images, cfg.patch_size) + self.pos_embed[None, 1:]
        x, mask, ids_restore = random_masking(x, noise, cfg.mask_ratio)
        cls = (self.cls_token + self.pos_embed[:1])[None].expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        for lp in self.layers:
            x = vit_block(x, lp, cfg.num_heads, cfg.eps)
        return layer_norm(x, self.norm.scale, self.norm.bias, eps=cfg.eps), mask, ids_restore

    def decode(self, latent, ids_restore):
        """latent (b, 1 + len_keep, d) -> patch pixels (b, num_patches,
        patch² · C), the mask tokens un-shuffled into place."""
        cfg, dp = self.config, self.decoder
        x = dense(latent, dp.embed)
        b, N = ids_restore.shape
        mask_tokens = dp.mask_token[None, None].expand(b, N + 1 - x.shape[1], cfg.decoder_dim)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, cfg.decoder_dim))
        x = torch.cat([x[:, :1], x_], dim=1) + dp.pos_embed[None]
        for lp in dp.layers:
            x = vit_block(x, lp, cfg.decoder_num_heads, cfg.eps)
        x = layer_norm(x, dp.norm.scale, dp.norm.bias, eps=cfg.eps)
        return dense(x, dp.pred)[:, 1:]

    def forward(self, images, noise):
        """-> (logits, mask, ids_restore)."""
        latent, mask, ids_restore = self.encode(images, noise)
        return self.decode(latent, ids_restore), mask, ids_restore


def mae_loss(model: MAE, images, noise, norm_pix: bool = False):
    """Mean per-patch squared error over the removed patches."""
    logits, mask, _ = model(images, noise)
    p = model.config.patch_size
    b, C, H, W = images.shape
    t = images.reshape(b, C, H // p, p, W // p, p)
    target = torch.einsum("bchpwq->bhwpqc", t).reshape(b, -1, p * p * C)
    if norm_pix:
        mu = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mu) / torch.sqrt(var + 1e-6)
    per_patch = ((logits - target) ** 2).mean(-1)
    return (per_patch * mask).sum() / mask.sum()


def mae_from_hf(sd: Dict, cfg: MAEConfig) -> Dict[str, torch.Tensor]:
    """HF ViTMAEForPreTraining state dict -> `MAE.state_dict()` names."""
    e, dec = "vit.embeddings.", "decoder."
    out = pick(sd, {"patch_embed.weight": e + "patch_embeddings.projection.weight",
                    "patch_embed.bias": e + "patch_embeddings.projection.bias",
                    "norm.scale": "vit.layernorm.weight", "norm.bias": "vit.layernorm.bias",
                    "decoder.embed.weight": dec + "decoder_embed.weight",
                    "decoder.embed.bias": dec + "decoder_embed.bias",
                    "decoder.norm.scale": dec + "decoder_norm.weight",
                    "decoder.norm.bias": dec + "decoder_norm.bias",
                    "decoder.pred.weight": dec + "decoder_pred.weight",
                    "decoder.pred.bias": dec + "decoder_pred.bias"})
    out["cls_token"] = torch.as_tensor(sd[e + "cls_token"])[0]
    out["pos_embed"] = torch.as_tensor(sd[e + "position_embeddings"])[0]
    out["decoder.mask_token"] = torch.as_tensor(sd[dec + "mask_token"])[0, 0]
    out["decoder.pos_embed"] = torch.as_tensor(sd[dec + "decoder_pos_embed"])[0]
    out.update(hf_vit_layers(sd, cfg.num_layers, "vit.encoder.layer.{}."))
    out.update({f"decoder.{k}": v for k, v in
                hf_vit_layers(sd, cfg.decoder_num_layers, dec + "decoder_layers.{}.").items()})
    return out
