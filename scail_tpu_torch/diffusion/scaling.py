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


@register(alias="sgm.modules.diffusionmodules.denoiser_scaling.EDMScaling")
class EDMScaling:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def __call__(self, sigma, **kw):
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


@register(alias="sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling")
class EpsScaling:
    def __call__(self, sigma, **kw):
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        return torch.ones_like(sigma), -sigma, c_in, sigma


@register(alias="sgm.modules.diffusionmodules.denoiser_scaling.VScaling")
class VScaling:
    def __call__(self, sigma, **kw):
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        return c_skip, c_out, c_in, sigma


@register(alias="sgm.modules.diffusionmodules.denoiser_scaling.VideoScaling")
class VideoScaling:
    """The sqrt(alphas_cumprod) parametrization: the 'sigma' is
    alphas_cumprod_sqrt and c_noise is the timestep index `idx`."""

    def __call__(self, alphas_cumprod_sqrt, idx=None, **kw):
        c_skip = alphas_cumprod_sqrt
        c_out = -torch.sqrt(1.0 - alphas_cumprod_sqrt ** 2)
        return c_skip, c_out, torch.ones_like(alphas_cumprod_sqrt), idx


@register(alias="sgm.modules.diffusionmodules.denoiser_weighting.UnitWeighting")
class UnitWeighting:
    def __call__(self, sigma):
        return torch.ones_like(sigma)


@register(alias="sgm.modules.diffusionmodules.denoiser_weighting.VWeighting")
class VWeighting:
    def __call__(self, sigma):
        return 1.0 / (sigma ** 2 + 1.0)
