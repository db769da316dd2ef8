"""Denoiser wrappers (counterpart of scail_tpu/diffusion/denoiser.py):
out = net(x * c_in, c_noise) * c_out + x * c_skip.

`DiscreteDenoiser` snaps sigma to the nearest rung of its ladder and, with
quantize_c_noise, passes the rung's index to the network as c_noise (the
SD-family UNets take integer timesteps); `DiscreteDenoiserTASD` does the same
for a per-frame (b, t) sigma.
"""

from __future__ import annotations

import numpy as np
import torch

from scail_tpu_torch.utils.misc import append_dims
from scail_tpu_torch.utils.registry import instantiate_from_config, register


@register(alias="sgm.modules.diffusionmodules.denoiser.Denoiser")
class Denoiser:
    def __init__(self, weighting_config, scaling_config):
        self.weighting = instantiate_from_config(weighting_config)
        self.scaling = instantiate_from_config(scaling_config)

    def possibly_quantize_sigma(self, sigma):
        return sigma

    def possibly_quantize_c_noise(self, c_noise):
        return c_noise

    def w(self, sigma):
        return self.weighting(sigma)

    def __call__(self, network_fn, x, sigma, cond, **kw):
        sigma = self.possibly_quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()), **kw)
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma.shape))
        out = network_fn((x * c_in).to(x.dtype), c_noise, cond, **kw)
        return out.float() * c_out + x.float() * c_skip


@register(alias="sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser")
class DiscreteDenoiser(Denoiser):
    def __init__(self, weighting_config, scaling_config, num_idx, discretization_config,
                 do_append_zero=False, quantize_c_noise=True, flip=True):
        super().__init__(weighting_config, scaling_config)
        disc = instantiate_from_config(discretization_config)
        self.sigmas_np = np.asarray(disc(num_idx, do_append_zero=do_append_zero, flip=flip),
                                    np.float32)
        self._sigmas = {}
        self.quantize_c_noise = quantize_c_noise

    def sigmas(self, device) -> torch.Tensor:
        """The ladder as an f32 tensor on `device` (made once per device)."""
        key = str(device)
        if key not in self._sigmas:
            self._sigmas[key] = torch.from_numpy(self.sigmas_np).to(device)
        return self._sigmas[key]

    def sigma_to_idx(self, sigma):
        """Index of the nearest rung (the first on a tie), sigma's shape."""
        ladder = self.sigmas(sigma.device).reshape((-1,) + (1,) * sigma.dim())
        return (sigma[None] - ladder).abs().argmin(dim=0).reshape(sigma.shape)

    def idx_to_sigma(self, idx):
        return self.sigmas(idx.device)[idx]

    def possibly_quantize_sigma(self, sigma):
        return self.idx_to_sigma(self.sigma_to_idx(sigma))

    def possibly_quantize_c_noise(self, c_noise):
        return self.sigma_to_idx(c_noise) if self.quantize_c_noise else c_noise


@register(alias="sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser_TASD")
class DiscreteDenoiserTASD(DiscreteDenoiser):
    """The TASD variant: sigma is per frame, (b, t).  The nearest-rung lookup
    of DiscreteDenoiser already broadcasts over any rank of sigma."""
