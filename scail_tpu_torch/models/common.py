"""Shared building blocks (counterpart of scail_tpu/models/common.py)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.ops.quant import QuantizedLinear, dense_quantized


def dense(layer: nn.Module, x, impl: str = "auto"):
    """x @ W^T + b in x.dtype (the JAX `dense` with an (in, out) kernel).  A
    QuantizedLinear goes to the W8A16/W4A16 matmul (ops/quant.py; `impl`
    'auto' kernel, 'xla' plain version).  A layer that carries LoRA factors
    (training/lora.py: lora_a (in, r), lora_b (r, out), lora_scale) adds
    lora_scale * (x @ lora_a) @ lora_b after the bias, in x.dtype."""
    if isinstance(layer, QuantizedLinear):
        y = dense_quantized(layer, x, impl=impl)
    else:
        bias = layer.bias.to(x.dtype) if layer.bias is not None else None
        y = F.linear(x, layer.weight.to(x.dtype), bias)
    if getattr(layer, "lora_a", None) is not None:
        delta = (x @ layer.lora_a.to(x.dtype)) @ layer.lora_b.to(x.dtype)
        y = y + layer.lora_scale.to(x.dtype) * delta
    return y


def gelu_tanh(x):
    """nn.GELU(approximate='tanh'): DiT MLP, text embedding, umt5 FFN."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """nn.GELU() (erf): the clip projection MLP and the CLIP ViT."""
    return F.gelu(x)


def silu(x):
    return F.silu(x)


def quick_gelu(x):
    """x * sigmoid(1.702 x): the activation of openai CLIP (ViT-L/14)."""
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32):
    """Sinusoidal embedding in [cos | sin] order (cos first)."""
    half = dim // 2
    exponent = (-math.log(max_period) * np.arange(half, dtype=np.float64) / half).astype(np.float32)
    freqs = torch.exp(torch.from_numpy(exponent).to(timesteps.device))
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


def container(**children) -> nn.Module:
    """An nn.Module holding the given submodules / parameters, so state_dict
    paths mirror the JAX parameter trees (a/b/kernel -> a.b.weight)."""
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def parameter(*shape, fill=None, device=None, dtype=torch.float32) -> nn.Parameter:
    t = torch.empty(*shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def linear(d_in, d_out, bias=True, device=None, dtype=torch.float32) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype)
    layer.requires_grad_(False)
    return layer


def random_init_(module: nn.Module, generator: torch.Generator, std=0.02, *, device=None,
                 dtype=None) -> None:
    """Random smoke-mode weights: norm scales/gammas one, biases zero, every
    other parameter N(0, std) where `std` is a float or a function
    (name, parameter) -> float.

    A parameter on the meta device is first made in f32 on `device`; with
    `dtype`, each parameter is cast once drawn.  Parameters are drawn one at
    a time in named_parameters() order, so a module built on meta is filled
    with the same values as one built on `device` and cast afterwards, and
    never holds a whole f32 copy."""
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            for leaf, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                if p.is_meta:
                    p = torch.empty(p.shape, dtype=torch.float32, device=device)
                if leaf in ("scale", "gamma"):
                    p.fill_(1.0)
                elif leaf == "bias":
                    p.zero_()
                else:
                    p.normal_(0.0, std(name, p) if callable(std) else std, generator=generator)
                if dtype is not None:
                    p = p.to(dtype)
                if p is not mod._parameters[leaf]:
                    mod._parameters[leaf] = nn.Parameter(p, requires_grad=False)
