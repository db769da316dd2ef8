"""Denoiser wrapper (counterpart of scail_tpu/diffusion/denoiser.py):
out = net(x * c_in, c_noise) * c_out + x * c_skip."""

from __future__ import annotations

from scail_tpu_torch.utils.misc import append_dims
from scail_tpu_torch.utils.registry import instantiate_from_config, register


@register(alias="sgm.modules.diffusionmodules.denoiser.Denoiser")
class Denoiser:
    def __init__(self, weighting_config, scaling_config):
        self.weighting = instantiate_from_config(weighting_config)
        self.scaling = instantiate_from_config(scaling_config)

    def w(self, sigma):
        return self.weighting(sigma)

    def __call__(self, network_fn, x, sigma, cond, **kw):
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()), **kw)
        out = network_fn((x * c_in).to(x.dtype), c_noise.reshape(sigma.shape), cond, **kw)
        return out.float() * c_out + x.float() * c_skip
