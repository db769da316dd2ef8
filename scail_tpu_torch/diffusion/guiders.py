"""Classifier-free guidance (counterpart of scail_tpu/diffusion/guiders.py).

`prepare_cond` merges (cond, uncond) into one batch-doubled dict: keys in
{vector, crossattn, concat} are concatenated [uc; c]; every other tensor is
shared and tiled to the doubled batch.
"""

from __future__ import annotations

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

    def prepare_cond(self, c: Dict, uc: Dict) -> Dict:
        out = {}
        for k, v in c.items():
            if k in CFG_CAT_KEYS:
                out[k] = torch.cat([_pad_uc_tokens(uc[k], v), v], dim=0)
            else:
                out[k] = torch.cat([v, v], dim=0)
        return out

    def __call__(self, x, sigma=None, scale=None):
        x_u, x_c = x.chunk(2, dim=0)
        s = self.scale if scale is None else scale
        return x_u + s * (x_c - x_u)


@register(alias="sgm.modules.diffusionmodules.guiders.IdentityGuider")
class IdentityGuider:
    scale = 1.0

    def prepare_cond(self, c, uc):
        return dict(c)

    def __call__(self, x, sigma=None, scale=None):
        return x
