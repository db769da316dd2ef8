"""Denoiser scaling and loss weighting (counterpart of scail_tpu/diffusion/scaling.py)."""

from __future__ import annotations

import torch

from scail_tpu_torch.utils.registry import register


@register(alias="sgm.modules.diffusionmodules.denoiser_scaling.RFScaling")
class RFScaling:
    """Rectified flow: identity wrapper, timestep = sigma * 1000."""

    def __call__(self, sigma, **kw):
        ones = torch.ones_like(sigma)
        return torch.zeros_like(sigma), ones, ones, sigma * 1000.0


@register(alias="sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting")
class EpsWeighting:
    def __call__(self, sigma):
        return sigma ** -2.0
