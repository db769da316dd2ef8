"""Training loss (counterpart of scail_tpu/diffusion/loss.py: the standard
loss's weighted L2 / L1 and RFLoss, the SCAIL objective).

RFLoss: sigma ~ LogisticNormal, optionally shifted by resolution; only the
non-history frames are noised, x_sigma = (1 - sigma) x + sigma noise; the
target is the rectified-flow velocity noise - x, and the L2 error is masked to
the generated frames.  Sigma and noise come from an explicit torch.Generator,
in that order, or are passed in (`sigma=`, `noise=`) by a caller that must
reproduce given draws.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from scail_tpu_torch.utils.misc import append_dims
from scail_tpu_torch.utils.registry import instantiate_from_config, register


@register(alias="sgm.modules.diffusionmodules.loss.StandardDiffusionLoss")
class StandardDiffusionLoss:
    def __init__(self, sigma_sampler_config=None, type: str = "l2", **kw):
        self.sigma_sampler = (instantiate_from_config(sigma_sampler_config)
                              if sigma_sampler_config is not None else None)
        if type not in ("l2", "l1"):
            raise ValueError(f"unknown loss type {type!r}")
        self.type = type

    def get_loss(self, model_output, target, w):
        """Per-sample mean of w * err^2 (or w * |err|): shape (b,)."""
        b = target.shape[0]
        err = model_output - target
        per = w * (err.square() if self.type == "l2" else err.abs())
        return per.reshape(b, -1).mean(dim=1)

    def _draw(self, generator, input, sigma, noise):
        """Sigma (b,) then noise like input, from the generator unless given."""
        if sigma is None:
            sigma = self.sigma_sampler(generator, input.shape[0])
        if noise is None:
            noise = torch.randn(input.shape, generator=generator, device=input.device)
        return sigma, noise


def time_shift(mu: float, t):
    """Resolution shift of sigma ('normal' mode): e^mu / (e^mu + 1/t - 1)."""
    return math.exp(mu) / (math.exp(mu) + 1.0 / t - 1.0)


def resolution_shift_mu(image_seq_len: int) -> float:
    """The shift's mu, linear in the per-frame token count: 0.5 at 256 tokens,
    1.15 at 4096."""
    m = (1.15 - 0.5) / (4096 - 256)
    return float(m * image_seq_len + 0.5 - m * 256)


@register(alias="sgm.modules.diffusionmodules.loss.RFLoss")
class RFLoss(StandardDiffusionLoss):
    def __init__(self, schedule_shift: bool = False, **kw):
        super().__init__(**kw)
        self.schedule_shift = schedule_shift

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *,
                 history_mask: Optional[torch.Tensor] = None, patch_size=(1, 2, 2),
                 sigma=None, noise=None, **model_kwargs):
        """input (b, T, C, H, W) latent; history_mask (b, T, 4, H, W) marks
        clean history frames.  Returns the per-sample loss (b,)."""
        sigma, noise = self._draw(generator, input, sigma, noise)
        if self.schedule_shift:
            tokens = input.shape[-1] * input.shape[-2] // patch_size[-1] // patch_size[-2]
            sigma = time_shift(resolution_shift_mu(tokens), sigma)
        if history_mask is None:
            hist = torch.zeros_like(input[:, :, :1], dtype=torch.float32)
        else:
            hist = history_mask[:, :, :1].float()
        hist = hist.expand(input.shape)
        inp = input.float()
        sig_b = append_dims(sigma, input.dim())
        noised = inp * (1.0 - sig_b) + noise * (1.0 - hist) * sig_b  # history stays clean
        out = denoiser(network_fn, noised, sigma, cond, history_mask=history_mask,
                       **model_kwargs)
        return self.get_loss(out, noise - inp, 1.0 - hist)
