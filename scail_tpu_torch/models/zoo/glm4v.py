"""GLM-4V (counterpart of scail_tpu/models/zoo/glm4v.py): the EVA2-CLIP
tower's patch tokens (models/zoo/evaclip.py), a 2×2 stride-2 convolution, a
GLU adapter (linear, LayerNorm eps 1e-5, exact GELU, SiLU gate × up, down),
wrapped in learned boi / eoi rows and spliced into GLM-4's token embeddings
(models/zoo/glm.py) at `image_embed_mask`, in order, by a cumsum.

State-dict names mirror the JAX tree: `vit.*`, `adapter.{conv,linear_proj,
norm1,gate,up,down,boi,eoi}`, `glm.*`; the adapter's conv weight is the SAT
layout (out, in, 2, 2) in both.  `glm4v_adapter_from_sat` reads the SAT
ImageMixin names into the adapter's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from scail_tpu_torch.models.common import container, parameter
from scail_tpu_torch.models.zoo.common import LM, KVCache, dense, lin, norm, table
from scail_tpu_torch.models.zoo.evaclip import EVACLIP, EVACLIPConfig
from scail_tpu_torch.models.zoo.glm import Glm, GlmConfig
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class GLM4VConfig:
    glm: GlmConfig = GlmConfig()
    vit: EVACLIPConfig = EVACLIPConfig()
    proj_hidden_size: int = 4096   # the conv's output channels
    adapter_inner: int = 13696     # the GLU's inner width

    @property
    def image_length(self):
        """The vision rows a sequence holds: the grid halved each way, + boi, eoi."""
        g = self.vit.image_size // self.vit.patch_size
        return (g // 2) * (g // 2) + 2


class GLM4V(LM):
    def __init__(self, cfg: GLM4VConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        e, h, d, f = cfg.vit.dim, cfg.proj_hidden_size, cfg.glm.dim, cfg.adapter_inner
        self.vit = EVACLIP(cfg.vit, device)
        self.adapter = container(
            conv=container(weight=parameter(h, e, 2, 2, device=device),
                           bias=parameter(h, fill=0.0, device=device)),
            linear_proj=lin(h, d, device=device), norm1=norm(d, True, device),
            gate=lin(d, f, device=device), up=lin(d, f, device=device),
            down=lin(f, d, device=device), boi=table(1, d, device), eoi=table(1, d, device))
        self.glm = Glm(cfg.glm, device)

    def new_cache(self, batch: int) -> KVCache:
        return self.glm.new_cache(batch)

    def vision_tokens(self, images):
        """images (b, C, H, W) -> (b, image_length, glm.dim): [boi | projected
        patches | eoi]."""
        ap = self.adapter
        x = self.vit(images)
        b, s, e = x.shape
        g = int(s ** 0.5)
        x = x.transpose(1, 2).reshape(b, e, g, g)
        x = F.conv2d(x, ap.conv.weight, stride=2).flatten(2).transpose(1, 2) + ap.conv.bias
        x = dense(x, ap.linear_proj)
        x = F.gelu(layer_norm(x, ap.norm1.scale, ap.norm1.bias, eps=1e-5))
        x = dense(F.silu(dense(x, ap.gate)) * dense(x, ap.up), ap.down)
        d = x.shape[-1]
        return torch.cat([ap.boi[None].expand(b, 1, d), x, ap.eoi[None].expand(b, 1, d)], dim=1)

    def forward(self, tokens, images=None, image_embed_mask=None,
                cache: Optional[KVCache] = None):
        """tokens (b, s); image_embed_mask (b, s) bool, the image_length slots
        that take the vision rows -> (logits, cache)."""
        embeds = self.glm.embed[tokens]
        if images is not None:
            vis = self.vision_tokens(images)
            idx = (torch.cumsum(image_embed_mask.long(), dim=1) - 1).clamp(0, vis.shape[1] - 1)
            spliced = torch.take_along_dim(vis, idx[..., None], dim=1)
            embeds = torch.where(image_embed_mask[..., None], spliced.to(embeds.dtype), embeds)
        return self.glm(tokens, cache=cache, inputs_embeds=embeds)


def glm4v_adapter_from_sat(sd: Dict, prefix: str = "mixins.eva.") -> Dict[str, torch.Tensor]:
    """The reference ImageMixin's conv + GLU state dict -> `GLM4V.adapter`'s
    state-dict names."""
    g = lambda k: torch.as_tensor(sd[prefix + k])  # noqa: E731
    return {"conv.weight": g("conv.weight"), "conv.bias": g("conv.bias"),
            "linear_proj.weight": g("linear_proj.linear_proj.weight"),
            "norm1.scale": g("linear_proj.norm1.weight"),
            "norm1.bias": g("linear_proj.norm1.bias"),
            "gate.weight": g("linear_proj.gate_proj.weight"),
            "up.weight": g("linear_proj.dense_h_to_4h.weight"),
            "down.weight": g("linear_proj.dense_4h_to_h.weight"),
            "boi": g("boi")[0], "eoi": g("eoi")[0]}
