"""AutoencoderKL, the SD-family continuous first stage (counterpart of
scail_tpu/autoencoding/autoencoder_kl.py).

encoder -> 1x1 quant_conv (2z -> 2 embed) -> diagonal Gaussian (sample or
mode) -> 1x1 post_quant_conv -> decoder, NCHW.  The state dict names are the
reference's (`encoder.*`, `decoder.*`, `quant_conv.*`, `post_quant_conv.*`),
so a released first stage loads as it is (`load_torch_state_dict`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from scail_tpu_torch.autoencoding.regularizers import diagonal_gaussian_regularizer
from scail_tpu_torch.autoencoding.vqgan import Decoder, Encoder
from scail_tpu_torch.models.unet import conv, init_random_
from scail_tpu_torch.utils.registry import register


@register(alias="sgm.models.autoencoder.AutoencoderKL")
class AutoencoderKL(nn.Module):
    """`encode(x)` samples the latent (from `generator`, or `noise`) unless
    sample=False, which gives the posterior mode (what the inference wrapper
    always does)."""

    sample_default = True

    def __init__(self, ddconfig: Dict, embed_dim: int, lossconfig=None, loss_config=None,
                 ckpt_path: Optional[str] = None, device=None, **_):
        super().__init__()
        self.ddconfig = dict(ddconfig, double_z=True)
        self.embed_dim = embed_dim
        z = self.ddconfig["z_channels"]
        self.encoder = Encoder(**self.ddconfig, device=device)
        self.decoder = Decoder(**self.ddconfig, device=device)
        self.quant_conv = nn.Conv2d(2 * z, 2 * embed_dim, 1, device=device)
        self.post_quant_conv = nn.Conv2d(embed_dim, z, 1, device=device)
        self.requires_grad_(False)
        self.eval()
        self.loaded = False
        if ckpt_path and os.path.exists(str(ckpt_path)):
            from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

            self.load_reference_state_dict(load_torch_state_dict(ckpt_path))

    def init_random_(self, generator: torch.Generator, device=None):
        """Random weights as the JAX init draws them (torch's default conv
        init), on the generator's device."""
        return init_random_(self, generator, device=device)

    def load_reference_state_dict(self, sd, device=None):
        """A reference AutoencoderKL state dict (extra tensors, such as a
        training loss's, are ignored); a missing or misshapen tensor raises."""
        keys = set(self.state_dict())
        missing = sorted(keys - set(sd))
        if missing:
            raise KeyError(f"AutoencoderKL state dict lacks {len(missing)} tensors, "
                           f"e.g. {missing[:3]}")
        if any(p.is_meta for p in self.parameters()):
            self.to_empty(device=device or "cpu")
        self.load_state_dict({k: sd[k] for k in keys}, strict=True)
        self.loaded = True
        return self

    def moments(self, x):
        """x (b, 3, H, W) -> (b, 2 embed, H/f, W/f): mean and logvar."""
        return conv(self.quant_conv, self.encoder(x))

    def encode_with_reg(self, x, generator=None, sample: Optional[bool] = None, noise=None):
        sample = self.sample_default if sample is None else sample
        return diagonal_gaussian_regularizer(self.moments(x), generator, sample=sample,
                                             noise=noise)

    def encode(self, x, generator=None, sample: Optional[bool] = None, noise=None):
        return self.encode_with_reg(x, generator, sample, noise)[0]

    def decode(self, z):
        return self.decoder(conv(self.post_quant_conv, z))

    def forward(self, x, generator=None, noise=None):
        z, log = self.encode_with_reg(x, generator, noise=noise)
        return self.decode(z), log["kl_loss"]


@register(alias=("sgm.models.autoencoder.AutoencoderKLModeOnly",
                 "sgm.models.autoencoder.AutoencoderKLInferenceWrapper"))
class AutoencoderKLModeOnly(AutoencoderKL):
    """Deterministic encode: the posterior mean."""

    sample_default = False
