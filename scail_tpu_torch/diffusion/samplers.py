"""Samplers (counterpart of scail_tpu/diffusion/samplers.py).

`RFSampler`: 50-step Euler over the hunyuan-shifted schedule with
classifier-free guidance; the JAX `lax.scan` is a Python loop, and the CFG
batch is doubled inside each step.  `RFSamplerLong`: the temporally tiled
long-clip variant, each step denoising overlapping frame tiles with their own
pose conditioning and blending them with a triangle window.

The EDM-era zoo (Euler, Heun, DPM++ 2M and its SDE form, DDIM, Euler
ancestral, DPM++ 2S ancestral, linear multistep) denoises toward x0, the
denoiser's output, over a sigma ladder; `VideoDDIMSampler` steps the
sqrt(alphas_cumprod) ladder of the PD loss.  The ladder is a host constant,
so each step's coefficients are host f32 scalars.  Where the next sigma (Heun)
or sigma_down (DPM++ 2S) is 0, the second network call is skipped, as in the
reference; the JAX samplers make it under `scan` and discard it, so the
result is the same.  A stochastic sampler draws one normal tensor a step, all
steps, from a torch.Generator seeded with its `seed` on x's device, or takes
them from `noise=` (a sequence, one tensor a step).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scail_tpu_torch.diffusion.guiders import IdentityGuider
from scail_tpu_torch.utils import profiling
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


class BaseDiffusionSampler:
    def __init__(self, discretization_config, num_steps=None, guider_config=None,
                 verbose=False, device=None):
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(default(
            guider_config, {"target": "sgm.modules.diffusionmodules.guiders.IdentityGuider"}))
        self.verbose = verbose

    def _log_step(self, i: int, n: int) -> None:
        if self.verbose:
            print(f"[{type(self).__name__}] step {i + 1}/{n}", flush=True)


@register(alias="sgm.modules.diffusionmodules.sampling.RFSampler")
class RFSampler(BaseDiffusionSampler):
    """__call__(denoise_fn, x, cond, uc) with denoise_fn(x, sigma, cond, **kw)
    returning the model velocity."""

    def __init__(self, schedule_shift=False, hunyuan_schedule=False, shift_scale=7,
                 mode="normal", distill=False, **kw):
        super().__init__(**kw)
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
        with profiling.annotate("sampler.step"):
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
            profiling.mark_step(i)
            x = self.step(denoise_fn, x, float(sigmas[i]), float(sigmas[i + 1]), merged,
                          cfg_scale, **kw)
            self._log_step(i, len(sigmas) - 1)
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
            profiling.mark_step(i)
            x = self.long_step(denoise_fn, x, (float(sigmas[i]), float(sigmas[i + 1])),
                               tile_indices, cond, uc, cfg_scale=cfg_scale, **kw)
            self._log_step(i, len(sigmas) - 1)
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


# ---------------------------------------------------------------------------
# The EDM-era sampler zoo.  Sigmas are host f32 scalars; x is f32.
# ---------------------------------------------------------------------------
_F = np.float32
_EPS = _F(1e-20)


def _to_d(x, sigma: float, denoised):
    """The ODE derivative (x - denoised) / sigma."""
    return (x - denoised) / float(sigma)


def _ancestral_step_sigmas(sigma_from, sigma_to, eta=1.0):
    """(sigma_down, sigma_up) of an ancestral step, host f32."""
    sigma_from, sigma_to = _F(sigma_from), _F(sigma_to)
    if not eta:
        return sigma_to, _F(0.0)
    sigma_up = min(sigma_to, _F(eta) * np.sqrt(
        sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / max(sigma_from ** 2, _EPS)))
    return np.sqrt(sigma_to ** 2 - sigma_up ** 2), sigma_up


def _neg_log(sigma):
    return -np.log(max(_F(sigma), _EPS))


class _EDMBase(BaseDiffusionSampler):
    """The shared loop: x scaled by sqrt(1 + sigma_0^2), the CFG conditioning
    merged once, then step(call, x, state, sigma, next_sigma, draw) per pair
    of the ladder."""

    seed = None  # a stochastic sampler's noise seed

    def _wrap(self, denoise_fn, merged, cfg_scale, kw):
        """call(x, sigma) -> the guided denoised x0 (f32)."""
        double = not isinstance(self.guider, IdentityGuider)

        def call(x, sigma):
            s_in = torch.full((x.shape[0],), float(sigma), dtype=torch.float32,
                              device=x.device)
            if double:
                x, s_in = torch.cat([x, x]), torch.cat([s_in, s_in])
            out = denoise_fn(x, s_in, merged, cfg_scale=cfg_scale, **kw)
            return self.guider(out.float(), float(sigma), scale=cfg_scale)

        return call

    def _draw(self, x, noise):
        """draw() -> the next step's normal tensor like x: from `noise` when
        given, else from a generator seeded with self.seed."""
        if noise is not None:
            steps = iter(noise)
            return lambda: next(steps).to(device=x.device, dtype=torch.float32)
        if self.seed is None:
            return None
        gen = torch.Generator(device=x.device).manual_seed(int(self.seed))
        return lambda: torch.randn(x.shape, generator=gen, device=x.device)

    def sigmas(self, num_steps=None) -> np.ndarray:
        return np.asarray(self.discretization(default(num_steps, self.num_steps)), np.float32)

    def __call__(self, denoise_fn, x, cond: Dict, uc: Optional[Dict] = None, num_steps=None,
                 scale=None, noise: Optional[Sequence[torch.Tensor]] = None, **kw):
        uc = default(uc, cond)
        sigmas = self.sigmas(num_steps)
        cfg_scale = default(scale, getattr(self.guider, "scale", 1.0))
        call = self._wrap(denoise_fn, self.guider.prepare_cond(cond, uc), cfg_scale, kw)
        x = x.float() * float(np.sqrt(1.0 + sigmas[0] ** 2))
        draw = self._draw(x, noise)
        state = None
        n = len(sigmas) - 1
        for i in range(n):
            x, state = self.step(call, x, state, sigmas[i], sigmas[i + 1], draw)
            self._log_step(i, n)
        return x

    def step(self, call, x, state, sigma, next_sigma, draw):
        raise NotImplementedError


@register(alias="sgm.modules.diffusionmodules.sampling.EulerEDMSampler")
class EulerEDMSampler(_EDMBase):
    """Euler over the ladder; stochastic churn is taken as 0, as in JAX."""

    def __init__(self, s_churn=0.0, s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0, **kw):
        super().__init__(**kw)
        if s_churn != 0.0:
            raise NotImplementedError("stochastic churn (s_churn != 0) is not implemented")
        self.s_churn, self.s_tmin, self.s_tmax, self.s_noise = s_churn, s_tmin, s_tmax, s_noise

    def step(self, call, x, state, sigma, next_sigma, draw):
        d = _to_d(x, sigma, call(x, sigma))
        return x + float(next_sigma - sigma) * d, state


@register(alias="sgm.modules.diffusionmodules.sampling.HeunEDMSampler")
class HeunEDMSampler(EulerEDMSampler):
    """Heun's second-order correction, except into sigma 0 (one call there)."""

    def step(self, call, x, state, sigma, next_sigma, draw):
        d = _to_d(x, sigma, call(x, sigma))
        dt = float(next_sigma - sigma)
        euler = x + dt * d
        if next_sigma <= 0:
            return euler, state
        d2 = _to_d(euler, next_sigma, call(euler, next_sigma))
        return x + dt * (d + d2) / 2.0, state


def _dpmpp_2m(x, denoised, state, sigma, next_sigma, mult1, mult2, extra=None):
    """The DPM++ 2M update: first order on the first step and into sigma 0,
    else with the previous step's denoised.  `extra` is added to both."""
    t, t_next = _neg_log(sigma), _neg_log(next_sigma)
    h = t_next - t
    denoised_d = denoised
    if state is not None and state[1] > 0.0 and x.shape[0] * next_sigma >= 1e-14:
        old_denoised, prev_sigma = state
        r = (t - _neg_log(prev_sigma)) / (h if h != 0 else _F(1.0))
        denoised_d = float(1 + 1 / (2 * r)) * denoised - float(1 / (2 * r)) * old_denoised
    out = float(mult1) * x - float(mult2) * denoised_d
    if extra is not None:
        out = out + extra
    return out, (denoised, _F(sigma))


@register(alias="sgm.modules.diffusionmodules.sampling.DPMPP2MSampler")
class DPMPP2MSampler(_EDMBase):
    """DPM++ 2M: second-order multistep in -log(sigma)."""

    def step(self, call, x, state, sigma, next_sigma, draw):
        denoised = call(x, sigma)
        t, t_next = _neg_log(sigma), _neg_log(next_sigma)
        return _dpmpp_2m(x, denoised, state, sigma, next_sigma, np.exp(-t_next) / np.exp(-t),
                         np.expm1(-(t_next - t)))


@register(alias="sgm.modules.diffusionmodules.sampling.SDEDPMPP2MSampler")
class SDEDPMPP2MSampler(_EDMBase):
    """DPM++ 2M SDE: the 2M update with fresh noise each step."""

    def __init__(self, seed: int = 0, **kw):
        super().__init__(**kw)
        self.seed = seed

    def step(self, call, x, state, sigma, next_sigma, draw):
        noise = draw()
        denoised = call(x, sigma)
        t, t_next = _neg_log(sigma), _neg_log(next_sigma)
        h = t_next - t
        mult_noise = _F(next_sigma) * np.sqrt(max(_F(1) - np.exp(-2 * h), _F(0)))
        return _dpmpp_2m(x, denoised, state, sigma, next_sigma,
                         np.exp(-t_next) / np.exp(-t) * np.exp(-h), np.expm1(-2 * h),
                         extra=float(mult_noise) * noise)


@register(alias="sgm.modules.diffusionmodules.sampling.DDIMSampler")
class DDIMSampler(_EDMBase):
    """An Euler step to next_sigma * sqrt(1 - s_noise^2), plus s_noise *
    next_sigma of fresh noise."""

    def __init__(self, s_noise=0.1, seed: int = 0, **kw):
        super().__init__(**kw)
        self.s_noise = s_noise
        self.seed = seed

    def step(self, call, x, state, sigma, next_sigma, draw):
        noise = draw()
        d = _to_d(x, sigma, call(x, sigma))
        x = x + float(_F(next_sigma) * _F((1 - self.s_noise ** 2) ** 0.5) - _F(sigma)) * d
        if self.s_noise > 0:
            x = x + float(_F(self.s_noise) * _F(next_sigma)) * noise
        return x, state


@register(alias="sgm.modules.diffusionmodules.sampling.EulerAncestralSampler")
class EulerAncestralSampler(_EDMBase):
    """Euler to sigma_down, then sigma_up of fresh noise (none into sigma 0)."""

    def __init__(self, eta=1.0, s_noise=1.0, seed: int = 0, **kw):
        super().__init__(**kw)
        self.eta = eta
        self.s_noise = s_noise
        self.seed = seed

    def _ancestral_noise(self, x, noise, next_sigma, sigma_up):
        if next_sigma > 0:
            x = x + noise * self.s_noise * float(sigma_up)
        return x

    def step(self, call, x, state, sigma, next_sigma, draw):
        noise = draw()
        sigma_down, sigma_up = _ancestral_step_sigmas(sigma, next_sigma, self.eta)
        d = _to_d(x, sigma, call(x, sigma))
        x = x + float(sigma_down - _F(sigma)) * d
        return self._ancestral_noise(x, noise, next_sigma, sigma_up), state


@register(alias="sgm.modules.diffusionmodules.sampling.DPMPP2SAncestralSampler")
class DPMPP2SAncestralSampler(EulerAncestralSampler):
    """A second-order DPM++ step to sigma_down (an Euler step when sigma_down
    is 0, with one network call), then the ancestral noise."""

    def step(self, call, x, state, sigma, next_sigma, draw):
        noise = draw()
        sigma_down, sigma_up = _ancestral_step_sigmas(sigma, next_sigma, self.eta)
        denoised = call(x, sigma)
        sigma = _F(sigma)
        if sigma_down > 0:
            t, t_next = -np.log(sigma), -np.log(sigma_down)
            h = t_next - t
            sigma_s = np.exp(-(t + _F(0.5) * h))
            x2 = float(sigma_s / sigma) * x - float(np.expm1(_F(-0.5) * h)) * denoised
            denoised2 = call(x2, sigma_s)
            x = float(sigma_down / sigma) * x - float(np.expm1(-h)) * denoised2
        else:
            x = x + float(sigma_down - sigma) * _to_d(x, sigma, denoised)
        return self._ancestral_noise(x, noise, next_sigma, sigma_up), state


def _lms_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """Exact integral over [t_i, t_i+1] of the Lagrange basis polynomial j of
    the last `order` nodes."""
    num = np.poly1d([1.0])
    den = 1.0
    for k in range(order):
        if k == j:
            continue
        num = num * np.poly1d([1.0, -t[i - k]])
        den *= t[i - j] - t[i - k]
    P = num.integ()
    return float((P(t[i + 1]) - P(t[i])) / den)


@register(alias="sgm.modules.diffusionmodules.sampling.LinearMultistepSampler")
class LinearMultistepSampler(_EDMBase):
    """Linear multistep (Adams-Bashforth) over the ladder with up to `order`
    past derivatives, newest first; the coefficients, host f64 from the
    ladder, are stored f32."""

    def __init__(self, order=4, **kw):
        super().__init__(**kw)
        self.order = order

    def __call__(self, denoise_fn, x, cond: Dict, uc: Optional[Dict] = None, num_steps=None,
                 scale=None, **kw):
        sigmas = self.sigmas(num_steps)
        n = len(sigmas) - 1
        self._coeffs = np.zeros((n, self.order), np.float32)
        for i in range(n):
            for j in range(min(i + 1, self.order)):
                self._coeffs[i, j] = _lms_coeff(min(i + 1, self.order),
                                                sigmas.astype(np.float64), i, j)
        return super().__call__(denoise_fn, x, cond, uc=uc, num_steps=num_steps, scale=scale,
                                **kw)

    def step(self, call, x, state, sigma, next_sigma, draw):
        """state: (step index, past derivatives, newest first)."""
        i, ds = state or (0, [])
        ds = [_to_d(x, sigma, call(x, sigma))] + ds[: self.order - 1]
        upd = float(self._coeffs[i, 0]) * ds[0]
        for c, d in zip(self._coeffs[i, 1:], ds[1:]):
            upd = upd + float(c) * d
        return x + upd, (i + 1, ds)


@register(alias="sgm.modules.diffusionmodules.sampling.VideoDDIMSampler")
class VideoDDIMSampler(BaseDiffusionSampler):
    """DDIM over the sqrt(alphas_cumprod) ladder (VideoScaling): the sampler
    the PD loss steps with.  denoise_fn takes alphas_cumprod_sqrt as its
    'sigma' and the timestep index as `idx`; DynamicCFG ramps by step."""

    def prepare_sampling_loop(self, x, num_steps=None):
        ac_sqrt, timesteps = self.discretization(default(num_steps, self.num_steps),
                                                 return_idx=True)
        ac_sqrt = np.concatenate([np.asarray(ac_sqrt, np.float32), np.ones((1,), np.float32)])
        timesteps = np.concatenate([np.full((1,), -1, np.int64), np.asarray(timesteps)])
        return ac_sqrt, timesteps

    def sampler_step(self, denoise_fn, x, merged, ac, ac_next, timestep, cfg_scale, **kw):
        b, dev = x.shape[0], x.device
        a2 = torch.full((2 * b,), ac, dtype=torch.float32, device=dev)
        idx = torch.full((2 * b,), timestep, dtype=torch.float32, device=dev)
        out = denoise_fn(torch.cat([x, x]), a2, merged, idx=idx, cfg_scale=cfg_scale, **kw)
        denoised = self.guider(out.float(), (1 - ac ** 2) ** 0.5,
                               step_index=max(self.num_steps - timestep, 0), scale=cfg_scale)
        a_t = ((1 - ac_next ** 2) / (1 - ac ** 2)) ** 0.5  # host f64, as in JAX
        return a_t * x + (ac_next - ac * a_t) * denoised

    def __call__(self, denoise_fn, x, cond: Dict, uc: Optional[Dict] = None, num_steps=None,
                 scale=None, **kw):
        uc = default(uc, cond)
        cfg_scale = default(scale, getattr(self.guider, "scale", 1.0))
        ac_sqrt, timesteps = self.prepare_sampling_loop(x, num_steps)
        merged = self.guider.prepare_cond(cond, uc)
        x = x.float()
        n = len(ac_sqrt) - 1
        for i in range(n):
            x = self.sampler_step(denoise_fn, x, merged, float(ac_sqrt[i]), float(ac_sqrt[i + 1]),
                                  float(timesteps[-(i + 1)]), cfg_scale, **kw)
            self._log_step(i, n)
        return x


def make_tile_indices(num_frames: int, tile: int, overlap: int) -> List[List[int]]:
    """Overlapping temporal tiles covering [0, num_frames)."""
    if not 0 < overlap < tile:
        raise ValueError(f"need 0 < overlap < tile, got overlap {overlap}, tile {tile}")
    starts = list(range(0, max(num_frames - tile, 0) + 1, tile - overlap))
    if starts and starts[-1] + tile < num_frames:
        starts.append(num_frames - tile)
    return [list(range(s, s + tile)) for s in starts]
