"""The inputs of one run, made on the device from the seed.

One request's conditioning, at the shapes the port's conditioner gives: the
umt5 states of the prompt and of the empty prompt, the CLIP image tokens,
the VAE latent of the reference image and of the half-resolution pose video;
and the starting noise of each request.  Everything is normal, in the type
the conditioner hands over (bf16; the noise f32, as the engine draws it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.geometry import Geometry
from portbench.weights import derive_seed


def latent_shape(geo: Geometry, channels: int) -> Tuple[int, int, int, int]:
    """(T, C, H, W) of the latent the sampler denoises."""
    T, H, W = geo.latent
    return T, channels, H, W


def conditioning(seed: int, net: dict, traffic: dict, *, device,
                 dtype=torch.bfloat16) -> Tuple[Dict, Dict]:
    """(cond, uncond) dicts of one request, as the sampling CLI builds them:
    crossattn differs, the reference latent, the pose latent and the CLIP
    tokens are shared."""
    geo = Geometry(traffic["frames"], traffic["height"], traffic["width"])
    b = traffic["batch"]
    T, H, W = geo.latent
    c = net["out_channels"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "conditioning"))

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)

    text = draw(b, traffic["text_tokens"], net["text_dim"])
    empty = draw(b, traffic["text_tokens"], net["text_dim"])
    shared = {"ref_concat": draw(b, 1, c, H, W),
              "concat_smpl_render": draw(b, T, c, H // 2, W // 2)}
    if net.get("use_i2v_clip"):
        shared["image_clip_features"] = draw(b, traffic["clip_tokens"], net.get("clip_dim", 1280))
    return dict(shared, crossattn=text), dict(shared, crossattn=empty)


def noise(seed: int, request: int, net: dict, traffic: dict, *, device) -> torch.Tensor:
    """The starting noise (batch, T, C, H, W) f32 of request `request`."""
    geo = Geometry(traffic["frames"], traffic["height"], traffic["width"])
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "noise", str(request)))
    return torch.randn((traffic["batch"], *latent_shape(geo, net["out_channels"])),
                       generator=gen, device=device, dtype=torch.float32)
