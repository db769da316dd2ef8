"""The plain reference of the test-only two-expert toy denoiser, and the
recipe of its weights.

Two experts of one per-position MLP over the latent's channels: the
high-noise expert runs at sigma >= the configuration's boundary, the
low-noise one below it.  EDM preconditioning, CFG over [uncond; cond], and
the Euler step's velocity d = (x - D(x, sigma)) / sigma, in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.weights import derive_seed

Spec = List[Tuple[str, Tuple[int, ...]]]


def expert_spec(m: dict) -> Spec:
    c, h, k, f = m["channels"], m["hidden"], m["cond_dim"], m["freq_dim"]
    return [("fc_in.weight", (h, c)), ("fc_in.bias", (h,)), ("time.weight", (h, 2 * f)),
            ("ctx.weight", (h, k)), ("fc_out.weight", (c, h)), ("fc_out.bias", (c,))]


def draw(seed: int, network: str, spec: Spec, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} of one expert: normal, scaled by 1 / sqrt(fan in)."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", network))
    out = {}
    for name, shape in spec:
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        out[name] = t * (0.1 if len(shape) == 1 else 1.0 / math.sqrt(shape[-1]))
    return out


def sigmas(m: dict) -> np.ndarray:
    """The Karras ladder of num_steps sigmas from sigma_max to sigma_min, then 0 (f32)."""
    n, rho = m["num_steps"], m["rho"]
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = m["sigma_min"] ** (1 / rho), m["sigma_max"] ** (1 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0).astype(np.float32)


def expert(w: Dict[str, torch.Tensor], m: dict, x, sigma: float, ctx):
    """F(x, sigma, ctx) of one expert: x (B, T, C, H, W), ctx (B, K, cond_dim)."""
    f = torch.arange(m["freq_dim"], dtype=torch.float32, device=x.device)
    ang = math.log(sigma) / 4 * torch.exp(-f)
    temb = torch.cat([torch.sin(ang), torch.cos(ang)])
    bias = w["fc_in.bias"] + w["time.weight"] @ temb                      # (h,)
    cvec = ctx.mean(1) @ w["ctx.weight"].T                               # (B, h)
    rows = x.permute(0, 1, 3, 4, 2)                                      # (B, T, H, W, C)
    hid = rows @ w["fc_in.weight"].T + bias + cvec[:, None, None, None]
    hid = hid * torch.sigmoid(hid)
    out = hid @ w["fc_out.weight"].T + w["fc_out.bias"]
    return out.permute(0, 1, 4, 2, 3)


def velocity(m: dict, weights: Dict[str, Dict[str, torch.Tensor]], x, sigma: float, cond,
             uncond, control: bool = False):
    """d = (x - D) / sigma of the guided denoiser at sigma; with `control`
    every operand rounded to bfloat16 first."""
    if control:
        x = x.bfloat16().float()
        weights = {n: {k: t.bfloat16().float() for k, t in w.items()}
                   for n, w in weights.items()}
    w = weights["high" if sigma >= m["boundary_sigma"] else "low"]
    c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = sigma / math.sqrt(sigma ** 2 + 1.0)
    d_u, d_c = (c_skip * x + c_out * expert(w, m, c_in * x, sigma, ctx)
                for ctx in (uncond["context"], cond["context"]))
    denoised = d_u + m["cfg_scale"] * (d_c - d_u)
    return (x - denoised) / sigma
