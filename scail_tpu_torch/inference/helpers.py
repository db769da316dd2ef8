"""Inference helpers (counterpart of scail_tpu/inference/helpers.py).

`do_sample` / `do_img2img` drive an ImageDiffusionEngine through its
conditioner, sampler and first stage.  The images at this surface are the
JAX package's: channels-last (b, H, W, 3), in [-1, 1] going in and [0, 1]
coming out, and so are the latents returned with `return_latents` and taken
by `skip_encode` ((b, H/8, W/8, 4)); inside, the models compute in NCHW.
Randomness comes from a torch.Generator seeded with `seed` on the engine's
device (the start noise, then, for image-to-image, the offset noise), or is
passed in (`noise=`, `offset=`; `sampler_noise=` goes to a stochastic
sampler as its per-step draws).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from scail_tpu_torch.utils.misc import append_dims


def get_unique_embedder_keys_from_conditioner(conditioner) -> List[str]:
    return list({e.input_key for e in conditioner.embedders})


class Img2ImgDiscretizationWrapper:
    """The lowest `strength` fraction of the ladder: flipped ascending, cut to
    max(int(strength * len), 1) rungs, flipped back."""

    def __init__(self, discretization, strength: float = 1.0):
        if not 0.0 <= strength <= 1.0:
            raise ValueError(f"strength {strength} not in [0, 1]")
        self.discretization = discretization
        self.strength = strength

    def __call__(self, *args, **kwargs):
        sigmas = np.flip(np.asarray(self.discretization(*args, **kwargs)), 0)
        return np.flip(sigmas[: max(int(self.strength * len(sigmas)), 1)], 0).copy()


def get_batch(keys, value_dict: Dict, N: Union[List, tuple], device=None):
    """The conditioner's batch and uncond batch from the value dict; tensor
    values (f32, on `device`) repeat to prod(N) rows."""
    n = math.prod(N)

    def rows(*vals):
        return torch.tensor([list(vals)], dtype=torch.float32, device=device).repeat(n, 1)

    batch: Dict = {}
    batch_uc: Dict = {}
    for key in keys:
        if key == "txt":
            batch["txt"] = [value_dict["prompt"] or ""] * n
            batch_uc["txt"] = [value_dict["negative_prompt"] or ""] * n
        elif key == "original_size_as_tuple":
            batch[key] = rows(value_dict["orig_height"], value_dict["orig_width"])
        elif key == "crop_coords_top_left":
            batch[key] = rows(value_dict["crop_coords_top"], value_dict["crop_coords_left"])
        elif key == "aesthetic_score":
            batch[key] = rows(value_dict["aesthetic_score"])
            batch_uc[key] = rows(value_dict["negative_aesthetic_score"])
        elif key == "target_size_as_tuple":
            batch[key] = rows(value_dict["target_height"], value_dict["target_width"])
        else:
            batch[key] = value_dict[key]
    for key in batch:
        if key not in batch_uc and isinstance(batch[key], torch.Tensor):
            batch_uc[key] = batch[key]
    return batch, batch_uc


def _conditioning(model, value_dict, num_samples, force_uc_zero_embeddings, keep_crossattn):
    batch, batch_uc = get_batch(get_unique_embedder_keys_from_conditioner(model.conditioner),
                                value_dict, [num_samples], device=model.device)
    c, uc = model.conditioner.get_unconditional_conditioning(
        batch, batch_uc=batch_uc, force_uc_zero_embeddings=force_uc_zero_embeddings or [])
    for k in c:
        if not (keep_crossattn and k == "crossattn"):
            c[k], uc[k] = c[k][:num_samples], uc[k][:num_samples]
    return batch, c, uc


def _to_images(model, samples_z, filter, return_latents):
    samples = ((model.decode_first_stage(samples_z) + 1.0) / 2.0).clamp(0.0, 1.0)
    samples = samples.permute(0, 2, 3, 1)  # (b, H, W, 3)
    if filter is not None:
        samples = filter(samples)
    if return_latents:
        return samples, samples_z.permute(0, 2, 3, 1)
    return samples


@torch.no_grad()
def do_sample(model, sampler, value_dict: Dict, num_samples: int, H: int, W: int, C: int,
              F: int, force_uc_zero_embeddings: Optional[List] = None,
              batch2model_input: Optional[List] = None, return_latents: bool = False,
              filter=None, seed: int = 42, noise=None, sampler_noise=None):
    """Text-to-image: (b, H, W, 3) in [0, 1] on the engine's device (and the
    (b, H/F, W/F, C) latent with return_latents).  `noise`: the start noise,
    (b, C, H/F, W/F)."""
    batch, c, uc = _conditioning(model, value_dict, num_samples, force_uc_zero_embeddings,
                                 keep_crossattn=True)
    extra = {k: batch[k] for k in (batch2model_input or [])}
    if noise is None:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        noise = torch.randn((num_samples, C, H // F, W // F), generator=gen, device=model.device)
    samples_z = sampler(model.denoise_fn(**extra), noise.to(model.device, torch.float32),
                        cond=c, uc=uc, **({} if sampler_noise is None else
                                          {"noise": sampler_noise}))
    return _to_images(model, samples_z, filter, return_latents)


@torch.no_grad()
def do_img2img(img, model, sampler, value_dict: Dict, num_samples: int,
               force_uc_zero_embeddings: Optional[List] = None,
               additional_kwargs: Optional[Dict] = None, offset_noise_level: float = 0.0,
               return_latents: bool = False, skip_encode: bool = False, filter=None,
               seed: int = 42, noise=None, offset=None, sampler_noise=None):
    """Image-to-image and the refiner: `img` (b, H, W, 3) in [-1, 1], or with
    skip_encode a latent (b, H/8, W/8, 4).  The latent is noised to the first
    sigma of the (strength-cut) ladder and divided by sqrt(1 + sigma^2),
    which the sampler's prologue restores.  `noise`: (b, 4, H/8, W/8)."""
    _, c, uc = _conditioning(model, value_dict, num_samples, force_uc_zero_embeddings,
                             keep_crossattn=False)
    for k in (additional_kwargs or {}):
        c[k] = uc[k] = additional_kwargs[k]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    img = img.to(model.device, torch.float32).permute(0, 3, 1, 2)
    z = img if skip_encode else model.encode_first_stage(img, gen)
    if noise is None:
        noise = torch.randn(z.shape, generator=gen, device=model.device)
    noise = noise.to(model.device, torch.float32)
    sigma = float(np.asarray(sampler.discretization(sampler.num_steps))[0])
    if offset_noise_level > 0.0:
        if offset is None:
            offset = torch.randn((z.shape[0],), generator=gen, device=model.device)
        noise = noise + offset_noise_level * append_dims(offset.to(model.device), z.dim())
    noised_z = (z + noise * sigma) / float(np.sqrt(1.0 + sigma ** 2))
    samples_z = sampler(model.denoise_fn(), noised_z, cond=c, uc=uc,
                        **({} if sampler_noise is None else {"noise": sampler_noise}))
    return _to_images(model, samples_z, filter, return_latents)


def get_input_image_array(image) -> torch.Tensor:
    """A PIL image -> (1, h, w, 3) f32 in [-1, 1], its sides cut to multiples
    of 64."""
    w, h = image.size
    width, height = (x - x % 64 for x in (w, h))
    arr = np.asarray(image.resize((width, height)).convert("RGB"), np.float32)[None]
    return torch.from_numpy(arr / 127.5 - 1.0)


def perform_save_locally(save_path, samples) -> None:
    """One PNG per sample ((b, h, w, 3) in [0, 1]), numbered on from the files
    already in `save_path`."""
    from PIL import Image

    os.makedirs(save_path, exist_ok=True)
    base_count = len(os.listdir(save_path))
    arr = samples.detach().cpu().numpy() if isinstance(samples, torch.Tensor) else samples
    for s in np.asarray(arr):
        Image.fromarray((255.0 * s).round().astype(np.uint8)).save(
            os.path.join(save_path, f"{base_count:09}.png"))
        base_count += 1
