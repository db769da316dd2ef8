"""Training sigma sampler (counterpart of scail_tpu/diffusion/sigma_sampling.py).

Draws from an explicit torch.Generator; the JAX package draws from a PRNG key,
so the two give different numbers from one seed (the parity tests inject
the same sigma into both).
"""

from __future__ import annotations

import torch

from scail_tpu_torch.utils.registry import register


@register(alias="sgm.modules.diffusionmodules.sigma_sampling.RFSampling")
class RFSampling:
    """LogisticNormal(p_mean, p_std): sigma = sigmoid(N(p_mean, p_std))."""

    def __init__(self, p_mean: float = 0.0, p_std: float = 1.0):
        self.p_mean, self.p_std = p_mean, p_std

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        """f32 sigmas of `shape` (an int batch size or a tuple) on the
        generator's device."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        z = torch.randn(shape, generator=generator, device=generator.device)
        return torch.sigmoid(self.p_mean + self.p_std * z)
