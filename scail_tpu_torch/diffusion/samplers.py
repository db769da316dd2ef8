"""Rectified-flow samplers (counterpart of scail_tpu/diffusion/samplers.py).

`RFSampler`: 50-step Euler over the hunyuan-shifted schedule with
classifier-free guidance; the JAX `lax.scan` is a Python loop, and the CFG
batch is doubled inside each step.  `RFSamplerLong`: the temporally tiled
long-clip variant, each step denoising overlapping frame tiles with their own
pose conditioning and blending them with a triangle window.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scail_tpu_torch.utils.misc import default
from scail_tpu_torch.utils.registry import instantiate_from_config, register


def make_flow_sigmas(num_steps: int, shift_scale: float = 7.0, t_start: float = 0.0,
                     mode: str = "normal") -> np.ndarray:
    """Hunyuan shift schedule; mode 'normal' runs sigma 1 -> 0."""
    s = np.linspace(t_start, 1.0, num_steps + 1, endpoint=True)
    s = s / (shift_scale + s - shift_scale * s)
    if mode == "meta":
        out = s
    elif mode == "normal":
        out = 1.0 - s
    else:
        raise ValueError(mode)
    return out.astype(np.float32)


def get_lin_function(x1: float = 256, y1: float = 0.5, x2: float = 4096, y2: float = 1.15):
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def time_shift(mu: float, t, mode: str = "normal"):
    if mode == "meta":
        return 1.0 / (1.0 + math.exp(mu) / t - math.exp(mu))
    if mode == "normal":
        return math.exp(mu) / (math.exp(mu) + 1.0 / t - 1.0)
    raise ValueError(mode)


@register(alias="sgm.modules.diffusionmodules.sampling.RFSampler")
class RFSampler:
    """__call__(denoise_fn, x, cond, uc) with denoise_fn(x, sigma, cond, **kw)
    returning the model velocity."""

    def __init__(self, discretization_config, num_steps=None, guider_config=None,
                 verbose=False, schedule_shift=False, hunyuan_schedule=False,
                 shift_scale=7, mode="normal", distill=False, device=None):
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(default(
            guider_config, {"target": "sgm.modules.diffusionmodules.guiders.IdentityGuider"}))
        self.verbose = verbose
        self.schedule_shift = schedule_shift
        self.hunyuan_schedule = hunyuan_schedule
        self.shift_scale = shift_scale
        self.mode = mode
        self.distill = distill

    def sigma_schedule(self, x_shape, num_steps=None) -> np.ndarray:
        n = default(num_steps, self.num_steps)
        sigmas = np.asarray(self.discretization(n))
        if self.schedule_shift:
            mu = get_lin_function(y1=0.5, y2=1.15)(x_shape[-1] * x_shape[-2])
            sigmas = np.asarray([time_shift(mu, float(s), mode=self.mode) for s in sigmas],
                                dtype=np.float32)
        if self.hunyuan_schedule:
            sigmas = make_flow_sigmas(n, shift_scale=self.shift_scale, mode=self.mode)
        return sigmas.astype(np.float32)

    def step(self, denoise_fn, x, sigma: float, next_sigma: float, merged_cond: Dict,
             cfg_scale, **kw):
        """One Euler step x -> x + (next_sigma - sigma) * v (f32)."""
        s_in = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        if self.distill:
            v = denoise_fn(x, s_in, merged_cond, cfg_scale=cfg_scale, **kw).float()
        else:
            v = denoise_fn(torch.cat([x, x]), torch.cat([s_in, s_in]), merged_cond,
                           cfg_scale=cfg_scale, **kw)
            v = self.guider(v.float(), sigma, scale=cfg_scale)
        # the step size is an f32 difference, as in the JAX sampler
        dt = float(np.float32(next_sigma) - np.float32(sigma))
        return x + dt * v

    def __call__(self, denoise_fn, x, cond: Dict, uc: Optional[Dict] = None, num_steps=None,
                 scale=None, **kw):
        uc = default(uc, cond)
        sigmas = self.sigma_schedule(x.shape, num_steps)
        cfg_scale = default(scale, self.guider.scale)
        merged = dict(cond) if self.distill else self.guider.prepare_cond(cond, uc)
        x = x.float()
        for i in range(len(sigmas) - 1):
            x = self.step(denoise_fn, x, float(sigmas[i]), float(sigmas[i + 1]), merged,
                          cfg_scale, **kw)
            if self.verbose:
                print(f"[RFSampler] step {i + 1}/{len(sigmas) - 1}", flush=True)
        return x


@register(alias="sgm.modules.diffusionmodules.sampling.RFSamplerLong")
class RFSamplerLong(RFSampler):
    """Temporally tiled long-clip RF sampling.  tile_indices: equal-length
    lists of latent frame indices; every consecutive pair of tiles (k, k+1)
    is denoised per step with the pose conditioning cond['smpl_tiled'][:, k]
    and blended with a triangle weight window."""

    def __call__(self, denoise_fn, x, cond: Dict, uc: Optional[Dict] = None, num_steps=None,
                 scale=None, tile_indices: Sequence[Sequence[int]] = None, **kw):
        if tile_indices is None:
            raise ValueError("RFSamplerLong needs tile_indices (make_tile_indices)")
        uc = default(uc, cond)
        sigmas = self.sigma_schedule(x.shape, num_steps)
        cfg_scale = default(scale, self.guider.scale)
        x = x.float()
        for i in range(len(sigmas) - 1):
            x = self.long_step(denoise_fn, x, (float(sigmas[i]), float(sigmas[i + 1])),
                               tile_indices, cond, uc, cfg_scale=cfg_scale, **kw)
            if self.verbose:
                print(f"[RFSamplerLong] step {i + 1}/{len(sigmas) - 1}", flush=True)
        return x

    def long_step(self, denoise_fn, x, pair, tile_indices, cond, uc, cfg_scale=None, **kw):
        """One tiled Euler step x -> x + (next_sigma - sigma) * blended velocity
        (f32).  A tile inside the clip is denoised once with each neighbour,
        and each visit adds its triangle weights, as in the JAX sampler."""
        if len(tile_indices) < 2:
            raise ValueError(f"RFSamplerLong needs at least two tiles, got {len(tile_indices)}: "
                             "a clip no longer than one tile takes RFSampler")
        cfg_scale = default(cfg_scale, self.guider.scale)
        smpl_tiled = cond["smpl_tiled"]  # (b, n_tiles, T_tile, C, Hp, Wp)
        base_c = {k: v for k, v in cond.items() if k != "smpl_tiled"}
        base_uc = {k: v for k, v in uc.items() if k != "smpl_tiled"}
        seg_len = len(tile_indices[0])
        w = (np.arange(seg_len) + 0.5) * 2.0 / seg_len
        weight = torch.from_numpy(np.minimum(w, 2.0 - w).astype(np.float32)).to(x.device)
        tiles = [torch.as_tensor(list(t), dtype=torch.long, device=x.device)
                 for t in tile_indices]

        def denoise_tile(x_tile, s_in, smpl_tile):
            merged = self.guider.prepare_cond(dict(base_c, concat_smpl_render=smpl_tile),
                                              dict(base_uc, concat_smpl_render=smpl_tile))
            v = denoise_fn(torch.cat([x_tile, x_tile]), torch.cat([s_in, s_in]), merged,
                           cfg_scale=cfg_scale, **kw)
            return self.guider(v.float(), None, scale=cfg_scale)

        sigma, next_sigma = pair
        s_in = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        denoised = torch.zeros_like(x)
        wsum = torch.zeros((x.shape[1],), dtype=torch.float32, device=x.device)
        for k in range(len(tiles) - 1):
            for tk in (k, k + 1):
                idx = tiles[tk]
                v = denoise_tile(x[:, idx], s_in, smpl_tiled[:, tk])
                denoised.index_add_(1, idx, v * weight[None, :, None, None, None])
                wsum.index_add_(0, idx, weight)
        denoised = denoised / wsum[None, :, None, None, None]
        # the step size is an f32 difference, as in RFSampler.step
        dt = float(np.float32(next_sigma) - np.float32(sigma))
        return x + dt * denoised


def make_tile_indices(num_frames: int, tile: int, overlap: int) -> List[List[int]]:
    """Overlapping temporal tiles covering [0, num_frames)."""
    if not 0 < overlap < tile:
        raise ValueError(f"need 0 < overlap < tile, got overlap {overlap}, tile {tile}")
    starts = list(range(0, max(num_frames - tile, 0) + 1, tile - overlap))
    if starts and starts[-1] + tile < num_frames:
        starts.append(num_frames - tile)
    return [list(range(s, s + tile)) for s in starts]
