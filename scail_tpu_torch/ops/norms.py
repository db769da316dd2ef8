"""Normalization + AdaLN modulation (counterpart of scail_tpu/ops/norms.py).

Statistics are computed in float32 and the result is cast back to the input
dtype, as in the JAX package.
"""

from __future__ import annotations

import torch


def rms_norm(x, scale=None, *, eps: float = 1e-6):
    """RMS norm over the last dim; `scale` of shape (x.shape[-1],) or None.
    The SCAIL DiT applies it over the full q/k projection width."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        xf = scale.float() * xf
    return xf.to(x.dtype)


def layer_norm(x, scale=None, bias=None, *, eps: float = 1e-6):
    """LayerNorm over the last dim with optional affine."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def modulate(x, shift, scale):
    """AdaLN modulation: x * (1 + scale) + shift."""
    return x * (1 + scale) + shift


def channel_rms_norm(x, gamma, *, dim: int = 1, scale_by_sqrt_dim: bool = True):
    """F.normalize-style RMS norm over `dim` used by the Wan VAE:
    x / max(||x||_2, 1e-12) * sqrt(C) * gamma."""
    xf = x.float()
    norm = xf.square().sum(dim, keepdim=True).sqrt().clamp_min(1e-12)
    xf = xf / norm
    if scale_by_sqrt_dim:
        xf = xf * (x.shape[dim] ** 0.5)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (xf * gamma.float().reshape(shape)).to(x.dtype)
