"""The SD / SDXL sampling API on PyTorch (counterpart of
scail_tpu/inference/api.py): the ModelArchitecture / Sampler /
Discretization / Guider enums, SamplingParams / SamplingSpec, model_specs,
the get_{guider,discretization,sampler}_config builders and SamplingPipeline
with text_to_image, image_to_image and refiner.

The pipeline reads configs/inference/*.yaml, builds the model on `device`
(the card unless the caller passes "cpu") and, without the checkpoint file
of the spec, fills it with random weights from `seed` (smoke mode).  Images
in and out are channels-last (b, H, W, 3): in [-1, 1] in, in [0, 1] out, on
the engine's device.  Each call also takes `noise=` (the start noise, NCHW)
and `sampler_noise=` (a stochastic sampler's per-step draws), for a caller
that must reproduce given draws.
"""

from __future__ import annotations

import pathlib
from dataclasses import asdict, dataclass
from enum import Enum
from typing import Optional

import torch

from scail_tpu_torch.inference.helpers import (Img2ImgDiscretizationWrapper, do_img2img,
                                               do_sample)
from scail_tpu_torch.utils.registry import instantiate_from_config


class ModelArchitecture(str, Enum):
    SD_2_1 = "stable-diffusion-v2-1"
    SD_2_1_768 = "stable-diffusion-v2-1-768"
    SDXL_V0_9_BASE = "stable-diffusion-xl-v0-9-base"
    SDXL_V0_9_REFINER = "stable-diffusion-xl-v0-9-refiner"
    SDXL_V1_BASE = "stable-diffusion-xl-v1-base"
    SDXL_V1_REFINER = "stable-diffusion-xl-v1-refiner"


class Sampler(str, Enum):
    EULER_EDM = "EulerEDMSampler"
    HEUN_EDM = "HeunEDMSampler"
    EULER_ANCESTRAL = "EulerAncestralSampler"
    DPMPP2S_ANCESTRAL = "DPMPP2SAncestralSampler"
    DPMPP2M = "DPMPP2MSampler"
    LINEAR_MULTISTEP = "LinearMultistepSampler"


class Discretization(str, Enum):
    LEGACY_DDPM = "LegacyDDPMDiscretization"
    EDM = "EDMDiscretization"


class Guider(str, Enum):
    VANILLA = "VanillaCFG"
    IDENTITY = "IdentityGuider"


class Thresholder(str, Enum):
    NONE = "None"


@dataclass
class SamplingParams:
    width: int = 1024
    height: int = 1024
    steps: int = 50
    sampler: Sampler = Sampler.DPMPP2M
    discretization: Discretization = Discretization.LEGACY_DDPM
    guider: Guider = Guider.VANILLA
    thresholder: Thresholder = Thresholder.NONE
    scale: float = 6.0
    aesthetic_score: float = 5.0
    negative_aesthetic_score: float = 5.0
    img2img_strength: float = 1.0
    orig_width: int = 1024
    orig_height: int = 1024
    crop_coords_top: int = 0
    crop_coords_left: int = 0
    sigma_min: float = 0.0292
    sigma_max: float = 14.6146
    rho: float = 3.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = 999.0
    s_noise: float = 1.0
    eta: float = 1.0
    order: int = 4


@dataclass
class SamplingSpec:
    width: int
    height: int
    channels: int
    factor: int
    is_legacy: bool
    config: str
    ckpt: str
    is_guided: bool


model_specs = {
    ModelArchitecture.SD_2_1: SamplingSpec(
        height=512, width=512, channels=4, factor=8, is_legacy=True,
        config="sd_2_1.yaml", ckpt="v2-1_512-ema-pruned.safetensors",
        is_guided=True),
    ModelArchitecture.SD_2_1_768: SamplingSpec(
        height=768, width=768, channels=4, factor=8, is_legacy=True,
        config="sd_2_1_768.yaml", ckpt="v2-1_768-ema-pruned.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_V0_9_BASE: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=False,
        config="sd_xl_base.yaml", ckpt="sd_xl_base_0.9.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_V0_9_REFINER: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=True,
        config="sd_xl_refiner.yaml", ckpt="sd_xl_refiner_0.9.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_V1_BASE: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=False,
        config="sd_xl_base.yaml", ckpt="sd_xl_base_1.0.safetensors",
        is_guided=True),
    ModelArchitecture.SDXL_V1_REFINER: SamplingSpec(
        height=1024, width=1024, channels=4, factor=8, is_legacy=True,
        config="sd_xl_refiner.yaml", ckpt="sd_xl_refiner_1.0.safetensors",
        is_guided=True),
}

# the YAMLs of configs/inference at the root of the checkout
_DEFAULT_CONFIG_DIR = str(
    pathlib.Path(__file__).resolve().parents[2] / "configs" / "inference")


class SamplingPipeline:
    def __init__(self, model_id: ModelArchitecture, model_path: str = "checkpoints",
                 config_path: Optional[str] = None, smoke: Optional[bool] = None,
                 seed: int = 0, device=None):
        """smoke=None: random weights when the spec's checkpoint file is
        absent.  device None: the card."""
        if model_id not in model_specs:
            raise ValueError(f"Model {model_id} not supported")
        self.model_id = model_id
        self.specs = model_specs[self.model_id]
        self.config = str(pathlib.Path(config_path or _DEFAULT_CONFIG_DIR, self.specs.config))
        self.ckpt = str(pathlib.Path(model_path, self.specs.ckpt))
        self.device = torch.device(device or "cuda")
        self.model = self._load_model(smoke=smoke, seed=seed)

    def _load_model(self, smoke, seed):
        from scail_tpu_torch.utils.config import load_configs

        model = instantiate_from_config(load_configs([self.config])["model"], device=self.device)
        if smoke is None:
            smoke = not pathlib.Path(self.ckpt).exists()
        if smoke:
            model.init_params(torch.Generator(device=model.device).manual_seed(seed))
        else:
            model.load_checkpoint(self.ckpt)
        return model

    def _uc_zero(self):
        return ["txt"] if not self.specs.is_legacy else []

    def text_to_image(self, params: SamplingParams, prompt: str, negative_prompt: str = "",
                      samples: int = 1, return_latents: bool = False, seed: int = 42,
                      noise=None, sampler_noise=None):
        value_dict = dict(asdict(params), prompt=prompt, negative_prompt=negative_prompt,
                          target_width=params.width, target_height=params.height)
        return do_sample(self.model, get_sampler_config(params), value_dict, samples,
                         params.height, params.width, self.specs.channels, self.specs.factor,
                         force_uc_zero_embeddings=self._uc_zero(), return_latents=return_latents,
                         seed=seed, noise=noise, sampler_noise=sampler_noise)

    def image_to_image(self, params: SamplingParams, image, prompt: str,
                       negative_prompt: str = "", samples: int = 1,
                       return_latents: bool = False, seed: int = 42, noise=None,
                       sampler_noise=None):
        """image: (b, H, W, 3) in [-1, 1]."""
        sampler = get_sampler_config(params)
        if params.img2img_strength < 1.0:
            sampler.discretization = Img2ImgDiscretizationWrapper(
                sampler.discretization, strength=params.img2img_strength)
        value_dict = dict(asdict(params), prompt=prompt, negative_prompt=negative_prompt,
                          target_width=image.shape[2], target_height=image.shape[1])
        return do_img2img(image, self.model, sampler, value_dict, samples,
                          force_uc_zero_embeddings=self._uc_zero(),
                          return_latents=return_latents, seed=seed, noise=noise,
                          sampler_noise=sampler_noise)

    def refiner(self, params: SamplingParams, image, prompt: str,
                negative_prompt: Optional[str] = None, samples: int = 1,
                return_latents: bool = False, seed: int = 42, noise=None, sampler_noise=None):
        """image: a base model's latent, (b, H/8, W/8, 4) (skip_encode)."""
        h, w = image.shape[1] * 8, image.shape[2] * 8
        value_dict = {"orig_width": w, "orig_height": h, "target_width": w,
                      "target_height": h, "prompt": prompt, "negative_prompt": negative_prompt,
                      "crop_coords_top": 0, "crop_coords_left": 0, "aesthetic_score": 6.0,
                      "negative_aesthetic_score": 2.5}
        return do_img2img(image, self.model, get_sampler_config(params), value_dict, samples,
                          skip_encode=True, return_latents=return_latents, seed=seed,
                          noise=noise, sampler_noise=sampler_noise)


def get_guider_config(params: SamplingParams):
    """The guider of `params` as a config."""
    if params.guider == Guider.IDENTITY:
        return {"target":
                "sgm.modules.diffusionmodules.guiders.IdentityGuider"}
    if params.guider == Guider.VANILLA:
        if params.thresholder != Thresholder.NONE:
            raise NotImplementedError(params.thresholder)
        dyn_thresh_config = {
            "target": ("sgm.modules.diffusionmodules.sampling_utils."
                       "NoDynamicThresholding")}
        return {"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                "params": {"scale": params.scale,
                           "dyn_thresh_config": dyn_thresh_config}}
    raise NotImplementedError(params.guider)


def get_discretization_config(params: SamplingParams):
    """The sigma ladder of `params` as a config."""
    if params.discretization == Discretization.LEGACY_DDPM:
        return {"target": ("sgm.modules.diffusionmodules.discretizer."
                           "LegacyDDPMDiscretization")}
    if params.discretization == Discretization.EDM:
        return {"target": ("sgm.modules.diffusionmodules.discretizer."
                           "EDMDiscretization"),
                "params": {"sigma_min": params.sigma_min,
                           "sigma_max": params.sigma_max,
                           "rho": params.rho}}
    raise ValueError(f"unknown discretization {params.discretization}")


def get_sampler_config(params: SamplingParams):
    """The chosen sampler over the chosen ladder and guider, instantiated."""
    discretization_config = get_discretization_config(params)
    guider_config = get_guider_config(params)
    common = dict(num_steps=params.steps,
                  discretization_config=discretization_config,
                  guider_config=guider_config)
    extra = {
        Sampler.EULER_EDM: dict(s_churn=params.s_churn, s_tmin=params.s_tmin,
                                s_tmax=params.s_tmax, s_noise=params.s_noise),
        Sampler.HEUN_EDM: dict(s_churn=params.s_churn, s_tmin=params.s_tmin,
                               s_tmax=params.s_tmax, s_noise=params.s_noise),
        Sampler.EULER_ANCESTRAL: dict(eta=params.eta, s_noise=params.s_noise),
        Sampler.DPMPP2S_ANCESTRAL: dict(eta=params.eta,
                                        s_noise=params.s_noise),
        Sampler.DPMPP2M: {},
        Sampler.LINEAR_MULTISTEP: dict(order=params.order),
    }.get(params.sampler)
    if extra is None:
        raise ValueError(f"unknown sampler {params.sampler}!")
    return instantiate_from_config({
        "target": ("sgm.modules.diffusionmodules.sampling."
                   f"{params.sampler.value}"),
        "params": {**common, **extra}})
