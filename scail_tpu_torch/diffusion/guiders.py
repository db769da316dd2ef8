"""Classifier-free guidance (counterpart of scail_tpu/diffusion/guiders.py).

`prepare_cond` merges (cond, uncond) into one batch-doubled dict: keys in
{vector, crossattn, concat} are concatenated [uc; c]; every other tensor is
shared and tiled to the doubled batch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from scail_tpu_torch.utils.registry import register

CFG_CAT_KEYS = ("vector", "crossattn", "concat")


def _pad_uc_tokens(uc, c):
    """Right-pad uc's token dim with its last token to match c."""
    if uc.shape[1] == c.shape[1]:
        return uc
    tail = uc[:, -1:].expand(-1, c.shape[1] - uc.shape[1], *uc.shape[2:])
    return torch.cat([uc, tail], dim=1)


@register(alias="sgm.modules.diffusionmodules.guiders.VanillaCFG")
class VanillaCFG:
    def __init__(self, scale: float, dyn_thresh_config=None):
        self.scale = scale

    def scale_at(self, sigma=None, step_index=None) -> float:
        return self.scale

    def prepare_cond(self, c: Dict, uc: Dict) -> Dict:
        out = {}
        for k, v in c.items():
            if k in CFG_CAT_KEYS:
                out[k] = torch.cat([_pad_uc_tokens(uc[k], v), v], dim=0)
            else:
                out[k] = torch.cat([v, v], dim=0)
        return out

    def __call__(self, x, sigma=None, step_index=None, scale=None):
        x_u, x_c = x.chunk(2, dim=0)
        s = self.scale_at(sigma, step_index) if scale is None else scale
        return x_u + s * (x_c - x_u)


@register(alias="sgm.modules.diffusionmodules.guiders.DynamicCFG")
class DynamicCFG(VanillaCFG):
    """A cosine ramp of the scale over the steps; a passed scale is ignored,
    as in the JAX guider."""

    def __init__(self, scale, exp, num_steps, dyn_thresh_config=None):
        super().__init__(scale)
        self.exp = exp
        self.num_steps = num_steps

    def scale_at(self, sigma=None, step_index=None) -> float:
        if step_index is None:
            raise ValueError("DynamicCFG needs the step index")
        return 1.0 + self.scale * (
            1 - math.cos(math.pi * (step_index / self.num_steps) ** self.exp)) / 2.0

    def __call__(self, x, sigma=None, step_index=None, scale=None):
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale_at(sigma, step_index) * (x_c - x_u)


@register(alias="sgm.modules.diffusionmodules.guiders.IdentityGuider")
class IdentityGuider:
    scale = 1.0

    def scale_at(self, sigma=None, step_index=None):
        return 1.0

    def prepare_cond(self, c, uc):
        return dict(c)

    def __call__(self, x, sigma=None, step_index=None, scale=None):
        return x


@register(alias="sgm.modules.diffusionmodules.guiders.LinearPredictionGuider")
class LinearPredictionGuider(VanillaCFG):
    """A scale ramped linearly over the frames of x (b, t, c, h, w), from
    min_scale to max_scale."""

    def __init__(self, max_scale, num_frames, min_scale=1.0, **kw):
        super().__init__(max_scale)
        self.min_scale = min_scale
        self.num_frames = num_frames

    def __call__(self, x, sigma=None, step_index=None, scale=None):
        x_u, x_c = x.chunk(2, dim=0)
        ramp = torch.linspace(self.min_scale, self.scale, self.num_frames, device=x.device)
        ramp = ramp.reshape((1, -1) + (1,) * (x_u.dim() - 2))
        return x_u + ramp * (x_c - x_u)
