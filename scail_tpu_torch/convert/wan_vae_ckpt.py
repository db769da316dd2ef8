"""Wan2.1_VAE.pth -> the port's WanVAEModel (counterpart of
scail_tpu/convert/wan_vae_ckpt.py).

WanVAEModel keeps the torch module paths (encoder.downsamples.{i}.residual.{j}
..., conv1, conv2) and PyTorch's convolution layouts, so the mapping is name
for name.  The one leaf whose layout differs is the RMS norm's gamma, stored
(c, 1, 1, 1) in the causal blocks and (c, 1, 1) in the attention blocks, and
held (c,) by the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from scail_tpu_torch.convert.torch_ckpt import mapped_state_dict


def wan_vae_source(name: str):
    """(key in the reference's file, layout fix) of a WanVAEModel parameter."""
    return name, (lambda t: t.reshape(-1)) if name.endswith(".gamma") else None


def wan_vae_state_dict_from_torch(sd: Mapping[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The reference VAE's state dict -> `WanVAEModel(cfg).state_dict()`, in
    the file's dtype."""
    from scail_tpu_torch.models.wan_vae import WanVAEModel

    return mapped_state_dict(WanVAEModel(cfg, device="meta"), sd, wan_vae_source,
                             "Wan VAE checkpoint")[0]
