"""XLM-Roberta-CLIP ViT-H/14 visual tower on PyTorch
(counterpart of scail_tpu/models/clip_vit.py).

`CLIPModel.visual` resizes the reference frame to 224 (torch bicubic,
antialias=False), normalizes with the CLIP statistics and returns the
penultimate block's tokens (31 of 32 blocks): (b, 257, 1280).  Attention is
plain math (einsum + f32 softmax), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.convert.torch_ckpt import (load_mapped_, load_torch_state_dict,
                                                mapped_state_dict)
from scail_tpu_torch.models.common import container, dense, gelu_exact, linear, parameter
from scail_tpu_torch.models.common import random_init_
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.ops.resize import resize_bicubic
from scail_tpu_torch.utils.registry import register

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    activation: str = "gelu"
    norm_eps: float = 1e-5
    pre_norm: bool = True
    dtype: str = "bfloat16"

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]


def _ln(d, device):
    return container(scale=parameter(d, fill=1.0, device=device),
                     bias=parameter(d, fill=0.0, device=device))


class ClipBlock(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, device=None):
        super().__init__()
        d = cfg.dim
        self.norm1 = _ln(d, device)
        self.to_qkv = linear(d, 3 * d, device=device)
        self.proj = linear(d, d, device=device)
        self.norm2 = _ln(d, device)
        self.mlp_fc1 = linear(d, cfg.mlp_ratio * d, device=device)
        self.mlp_fc2 = linear(cfg.mlp_ratio * d, d, device=device)


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, device=None):
        super().__init__()
        if cfg.activation != "gelu":
            raise NotImplementedError("only the GELU ViT-H/14 tower is ported")
        self.config = cfg
        d = cfg.dim
        self.patch_embedding = container(
            weight=parameter(d, 3, cfg.patch_size, cfg.patch_size, device=device))
        self.cls_embedding = parameter(1, 1, d, device=device)
        self.pos_embedding = parameter(1, cfg.num_patches + 1, d, device=device)
        self.pre_norm = _ln(d, device)
        self.layers = nn.ModuleList(ClipBlock(cfg, device) for _ in range(cfg.num_layers))

    def init_weights_(self, generator: torch.Generator) -> None:
        gain = self.config.dim ** -0.5
        random_init_(self, generator,
                     lambda name, p: gain if name.endswith("_embedding") else 0.02)

    def forward(self, images, use_31_block: bool = True):
        """images (b, 3, 224, 224) already normalized -> (b, 257, dim)."""
        cfg = self.config
        cdtype = cfg.compute_dtype
        b = images.shape[0]
        d, nh = cfg.dim, cfg.num_heads
        x = F.conv2d(images.to(cdtype), self.patch_embedding.weight.to(cdtype),
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_embedding.to(cdtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embedding.to(cdtype)
        x = layer_norm(x, self.pre_norm.scale, self.pre_norm.bias, eps=cfg.norm_eps)
        n_run = cfg.num_layers - 1 if use_31_block else cfg.num_layers
        for blk in self.layers[:n_run]:
            y = layer_norm(x, blk.norm1.scale, blk.norm1.bias, eps=cfg.norm_eps)
            q, k, v = dense(blk.to_qkv, y).unflatten(-1, (3, nh, d // nh)).unbind(2)
            logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (d // nh) ** -0.5
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            x = x + dense(blk.proj, torch.einsum("bnqk,bknd->bqnd", probs, v).flatten(2))
            y = layer_norm(x, blk.norm2.scale, blk.norm2.bias, eps=cfg.norm_eps)
            x = x + dense(blk.mlp_fc2, gelu_exact(dense(blk.mlp_fc1, y)))
        return x


def clip_visual_tokens(model: ClipVisionTower, images, *, use_31_block: bool = True):
    return model(images, use_31_block=use_31_block)


# ClipVisionTower module inside layer {i} -> the reference's inside transformer.{i}
_BLOCK_MODULES = {"norm1": "norm1", "to_qkv": "attn.to_qkv", "proj": "attn.proj",
                  "norm2": "norm2", "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}


def clip_vision_name(name: str) -> str:
    """The reference's name (without its optional 'visual.' prefix) of a
    ClipVisionTower parameter: the names differ, the layouts do not."""
    name = name.replace(".scale", ".weight")  # LayerNorm
    if not name.startswith("layers."):
        return name
    _, i, mod, leaf = name.split(".")
    return f"transformer.{i}.{_BLOCK_MODULES[mod]}.{leaf}"


def clip_vision_source(sd):
    """`source` for torch_ckpt.mapped_state_dict over a checkpoint `sd` whose
    names may carry the 'visual.' prefix (the JAX converter takes both)."""
    def source(name):
        key = clip_vision_name(name)
        return (key if key in sd else "visual." + key), None

    return source


def clip_vision_state_dict_from_torch(sd, cfg: ClipVisionConfig):
    """The reference checkpoint's visual tower ->
    `ClipVisionTower(cfg).state_dict()`, in the file's dtype (the JAX
    package's clip_vision_params_from_state_dict)."""
    return mapped_state_dict(ClipVisionTower(cfg, device="meta"), sd, clip_vision_source(sd),
                             "CLIP checkpoint")[0]


def clip_preprocess(frames, image_size: int = 224):
    """(b, 3, H, W) in [-1, 1] -> resized (torch bicubic, no antialias) and
    normalized with the CLIP statistics."""
    x = resize_bicubic(frames.float(), image_size, image_size, antialias=False)
    x = x * 0.5 + 0.5
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)[None, :, None, None]
    std = torch.from_numpy(CLIP_STD).to(x.device)[None, :, None, None]
    return (x - mean) / std


@register(alias="sgm.modules.encoders.clip.CLIPModel")
class CLIPModel:
    """Reference-surface wrapper: `.visual(videos)` with (b, c, t, h, w) input
    returns the penultimate tokens for all frames."""

    def __init__(self, dtype="bfloat16", checkpoint_path=None, device=None):
        self.config = ClipVisionConfig(dtype="bfloat16" if "bf" in str(dtype) else "float32")
        self.model = None
        self.checkpoint_path = None
        if checkpoint_path and os.path.exists(str(checkpoint_path)):
            # the file's tensors, memory-mapped on the CPU in its dtype; the
            # engine moves them to its device
            self.checkpoint_path = str(checkpoint_path)
            self.model = ClipVisionTower(self.config, device="meta")
            sd = load_torch_state_dict(self.checkpoint_path)
            load_mapped_(self.model, sd, clip_vision_source(sd),
                         what=f"CLIP {self.checkpoint_path}")

    def init(self, generator: torch.Generator, cfg: ClipVisionConfig = None, device=None):
        self.config = cfg or self.config
        self.model = ClipVisionTower(self.config, device=device)
        self.model.init_weights_(generator)
        self.model.to(self.config.compute_dtype)
        return self.model

    def visual(self, videos):
        b, c, t, h, w = videos.shape
        frames = videos.transpose(1, 2).reshape(b * t, c, h, w)
        return self.model(clip_preprocess(frames, self.config.image_size), use_31_block=True)
