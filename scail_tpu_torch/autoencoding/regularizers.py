"""Latent regularizers (counterpart of scail_tpu/autoencoding/regularizers.py):
the diagonal-Gaussian (KL) one, which the KL autoencoder needs.  Channels on
dim 1 (NCHW); the JAX function splits the last axis."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def diagonal_gaussian_regularizer(z, generator: Optional[torch.Generator] = None, *,
                                  sample: bool = True, noise=None
                                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z (b, 2c, ...): mean and logvar on dim 1.  Returns (latent (b, c, ...),
    {'kl_loss': scalar}): the mean, or with `sample` mean + std * noise
    (`noise` given, else drawn from `generator`).  logvar is clamped to
    [-30, 20]; the KL is summed over the non-batch dims and averaged over the
    batch."""
    mean, logvar = z.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("a sampling regularizer needs a generator or the noise")
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        out = mean + torch.exp(0.5 * logvar) * noise
    else:
        out = mean
    kl = 0.5 * (mean.float() ** 2 + torch.exp(logvar).float() - 1.0 - logvar.float())
    return out, {"kl_loss": kl.sum() / z.shape[0]}
