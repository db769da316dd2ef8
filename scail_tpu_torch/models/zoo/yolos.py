"""YOLOS object detector (counterpart of scail_tpu/models/zoo/yolos.py): a
ViT over [cls | patches | detection tokens] with per-layer "mid" position
embeddings and DETR-style class and box MLP heads.  Away from the trained
grid the position tables are resized bicubically with JAX's resize matrices
(ops/resize.py `resize_bicubic`; `F.interpolate`'s bicubic has another
coefficient and edge rule).

State-dict names mirror the JAX tree (`patch_embed`, `cls_token` (d,),
`det_tokens`, `pos_embed`, `mid_pos_embed` (L - 1, ...), `layers.{i}.*`
(`ViTLayer`), `norm`, `class_head.l{i}`, `bbox_head.l{i}`); `yolos_from_hf`
reads HF `YolosForObjectDetection` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import container, parameter
from scail_tpu_torch.models.zoo.common import (LM, ViTLayer, dense, hf_vit_layers, lin,
                                               norm, patch_conv, patchify, pick, table,
                                               vit_block)
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.ops.resize import resize_bicubic


@dataclasses.dataclass(frozen=True)
class YolosConfig:
    image_size: Tuple[int, int] = (512, 864)
    patch_size: int = 16
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    inner_hidden_size: int = 3072
    num_detection_tokens: int = 100
    num_labels: int = 91
    use_mid_position_embeddings: bool = True
    eps: float = 1e-12

    @property
    def grid(self):
        return self.image_size[0] // self.patch_size, self.image_size[1] // self.patch_size


def interp_pos(pos, cfg: YolosConfig, img_hw):
    """pos (..., 1 + N + det, d) -> the same over img_hw's patch grid."""
    gh, gw = cfg.grid
    nh, nw = img_hw[0] // cfg.patch_size, img_hw[1] // cfg.patch_size
    if (nh, nw) == (gh, gw):
        return pos
    det, d = cfg.num_detection_tokens, pos.shape[-1]
    lead, patch, tail = pos[..., :1, :], pos[..., 1:-det, :], pos[..., -det:, :]
    shp = patch.shape[:-2]
    grid = patch.reshape(shp + (gh, gw, d)).movedim(-1, -3)
    grid = resize_bicubic(grid.reshape(-1, d, gh, gw), nh, nw).reshape(shp + (d, nh, nw))
    patch = grid.movedim(-3, -1).reshape(shp + (nh * nw, d))
    return torch.cat([lead, patch, tail], dim=-2)


def _mlp_head(x, head):
    """The DETR prediction head: ReLU between its linears."""
    n = len(head._modules)
    for i in range(n):
        x = dense(x, getattr(head, f"l{i}"))
        if i < n - 1:
            x = F.relu(x)
    return x


def _head(sizes, device):
    return container(**{f"l{i}": lin(a, b, True, device)
                        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))})


class Yolos(LM):
    def __init__(self, cfg: YolosConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d, det = cfg.dim, cfg.num_detection_tokens
        n_tok = 1 + cfg.grid[0] * cfg.grid[1] + det
        self.patch_embed = patch_conv(3, d, cfg.patch_size, device)
        self.cls_token = parameter(d, device=device)
        self.det_tokens = table(det, d, device)
        self.pos_embed = table(n_tok, d, device)
        if cfg.use_mid_position_embeddings:
            self.mid_pos_embed = parameter(cfg.num_layers - 1, n_tok, d, device=device)
        self.layers = nn.ModuleList(ViTLayer(d, cfg.inner_hidden_size, device)
                                    for _ in range(cfg.num_layers))
        self.norm = norm(d, True, device)
        self.class_head = _head((d, d, d, cfg.num_labels + 1), device)
        self.bbox_head = _head((d, d, d, 4), device)

    def forward(self, images):
        """images (b, 3, H, W) -> (class logits (b, det, labels + 1), boxes
        (b, det, 4) in [0, 1], cxcywh)."""
        cfg = self.config
        b, _, H, W = images.shape
        det = cfg.num_detection_tokens
        x = patchify(self.patch_embed, images, cfg.patch_size)
        x = torch.cat([self.cls_token[None, None].expand(b, 1, cfg.dim), x,
                       self.det_tokens[None].expand(b, det, cfg.dim)], dim=1)
        x = x + interp_pos(self.pos_embed, cfg, (H, W))[None]
        mid = (interp_pos(self.mid_pos_embed, cfg, (H, W))
               if cfg.use_mid_position_embeddings else None)
        for li, lp in enumerate(self.layers):
            x = vit_block(x, lp, cfg.num_heads, cfg.eps)
            if mid is not None and li < cfg.num_layers - 1:
                x = x + mid[li][None]
        x = layer_norm(x, self.norm.scale, self.norm.bias, eps=cfg.eps)
        dets = x[:, -det:]
        return _mlp_head(dets, self.class_head), torch.sigmoid(_mlp_head(dets, self.bbox_head))


def yolos_from_hf(sd: Dict, cfg: YolosConfig) -> Dict[str, torch.Tensor]:
    """HF YolosForObjectDetection state dict -> `Yolos.state_dict()` names."""
    e = "vit.embeddings."
    out = pick(sd, {"patch_embed.weight": e + "patch_embeddings.projection.weight",
                    "patch_embed.bias": e + "patch_embeddings.projection.bias",
                    "norm.scale": "vit.layernorm.weight", "norm.bias": "vit.layernorm.bias"})
    out["cls_token"] = torch.as_tensor(sd[e + "cls_token"])[0, 0]
    out["det_tokens"] = torch.as_tensor(sd[e + "detection_tokens"])[0]
    out["pos_embed"] = torch.as_tensor(sd[e + "position_embeddings"])[0]
    if cfg.use_mid_position_embeddings:
        out["mid_pos_embed"] = torch.as_tensor(sd["vit.encoder.mid_position_embeddings"])[:, 0]
    out.update(hf_vit_layers(sd, cfg.num_layers, "vit.encoder.layer.{}."))
    for name, hf in (("class_head", "class_labels_classifier"), ("bbox_head", "bbox_predictor")):
        i = 0
        while f"{hf}.layers.{i}.weight" in sd:
            out.update(pick(sd, {f"{name}.l{i}.weight": f"{hf}.layers.{i}.weight",
                                 f"{name}.l{i}.bias": f"{hf}.layers.{i}.bias"}))
            i += 1
    return out
