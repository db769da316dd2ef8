"""Noise-level discretizations (counterpart of scail_tpu/diffusion/discretization.py).

Host-side numpy: the sigma ladder is a handful of constants per run.  Every
ladder takes the `do_append_zero` / `flip` / `return_idx` arguments the
samplers, denoisers and losses call it with; `return_idx` returns
(sigmas, timestep indices), None for the EDM ladder, which has no index.
"""

from __future__ import annotations

import numpy as np

from scail_tpu_torch.utils.registry import register


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def append_zero(x):
    return np.concatenate([x, np.zeros((1,), x.dtype)])


def append_one(x):
    return np.concatenate([x, np.ones((1,), x.dtype)])


def _finish(sigmas, idx, tail, flip: bool, return_idx: bool):
    """Append `tail` (a function of the ladder, or None), flip if asked, and
    return the ladder with or without its indices."""
    if tail is not None:
        sigmas = tail(sigmas)
    if flip:
        sigmas = np.flip(sigmas, 0).copy()
    return (sigmas, idx) if return_idx else sigmas


def _subsample(table: np.ndarray, n: int, num_timesteps: int):
    """(table at n roughly equally spaced steps, their indices)."""
    if n < num_timesteps:
        idx = generate_roughly_equally_spaced_steps(n, num_timesteps)
        return table[idx], idx
    if n == num_timesteps:
        return table, np.arange(n)
    raise ValueError(f"{n} steps from a ladder of {num_timesteps}")


@register(alias="sgm.modules.diffusionmodules.discretizer.RFDiscretization")
class RFDiscretization:
    """Rectified-flow sigmas in (0, 1]."""

    def __init__(self, num_timesteps: int = 1000, reverse: bool = False,
                 shift_scale: float = 1.0):
        self.num_timesteps = num_timesteps
        self.reverse = reverse
        grid = np.linspace(1, 0, num_timesteps + 1) if reverse else np.linspace(0, 1, num_timesteps + 1)
        self.sigmas = grid[1:]

    def get_sigmas(self, n: int, return_idx: bool = False):
        sigmas, idx = _subsample(self.sigmas, n, self.num_timesteps)
        sigmas = np.flip(sigmas, 0).astype(np.float32)
        return (sigmas, idx) if return_idx else sigmas

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False,
                 return_idx: bool = False):
        sigmas, idx = self.get_sigmas(n, return_idx=True)
        tail = (append_one if self.reverse else append_zero) if do_append_zero else None
        return _finish(sigmas, idx, tail, flip, return_idx)


@register(alias="sgm.modules.diffusionmodules.discretizer.EDMDiscretization")
class EDMDiscretization:
    """Karras et al.'s rho-spaced ladder from sigma_max down to sigma_min."""

    def __init__(self, sigma_min=0.002, sigma_max=80.0, rho=7.0):
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho

    def get_sigmas(self, n: int, return_idx: bool = False):
        ramp = np.linspace(0, 1, n)
        min_r = self.sigma_min ** (1 / self.rho)
        max_r = self.sigma_max ** (1 / self.rho)
        sigmas = ((max_r + ramp * (min_r - max_r)) ** self.rho).astype(np.float32)
        return (sigmas, None) if return_idx else sigmas

    def __call__(self, n, do_append_zero=True, flip=False, return_idx=False):
        return _finish(self.get_sigmas(n), None, append_zero if do_append_zero else None,
                       flip, return_idx)


@register(alias="sgm.modules.diffusionmodules.discretizer.ZeroSNRDDPMDiscretization")
class ZeroSNRDDPMDiscretization:
    """DDPM sqrt(alphas_cumprod) rescaled so the last step has zero SNR: the
    ladder VideoDDIMSampler, VideoScaling and the PD loss run on.  It appends
    nothing (the sampler appends alpha 1 itself)."""

    def __init__(self, linear_start=0.00085, linear_end=0.0120, num_timesteps=1000,
                 shift_scale=1.0, keep_start=False, post_shift=False):
        if keep_start and not post_shift:
            linear_start = linear_start / (shift_scale + (1 - shift_scale) * linear_start)
        self.num_timesteps = num_timesteps
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                            dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if not post_shift:
            self.alphas_cumprod = self.alphas_cumprod / (
                shift_scale + (1 - shift_scale) * self.alphas_cumprod)
        self.post_shift = post_shift
        self.shift_scale = shift_scale

    def get_sigmas(self, n: int, return_idx: bool = False):
        ac, idx = _subsample(self.alphas_cumprod, n, self.num_timesteps)
        s = np.sqrt(ac)
        s0, sT = s[0], s[-1]
        s = (s - sT) * s0 / (s0 - sT)  # zero terminal SNR
        if self.post_shift:
            s = np.sqrt(s ** 2 / (self.shift_scale + (1 - self.shift_scale) * s ** 2))
        s = np.flip(s, 0).astype(np.float32).copy()
        return (s, idx) if return_idx else s

    def __call__(self, n, do_append_zero=True, flip=False, return_idx=False):
        sigmas, idx = self.get_sigmas(n, return_idx=True)
        return _finish(sigmas, idx, None, flip, return_idx)


@register(alias="sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization")
class LegacyDDPMDiscretization:
    """The SD-family ladder: sigma = sqrt((1 - alphas_cumprod) / alphas_cumprod)
    of the scaled-linear beta schedule."""

    def __init__(self, linear_start=0.00085, linear_end=0.0120, num_timesteps=1000):
        self.num_timesteps = num_timesteps
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int, return_idx: bool = False):
        if n < self.num_timesteps:
            ac, idx = _subsample(self.alphas_cumprod, n, self.num_timesteps)
        else:
            ac, idx = self.alphas_cumprod, np.arange(n)
        sigmas = np.flip(((1 - ac) / ac) ** 0.5, 0).astype(np.float32)
        return (sigmas, idx) if return_idx else sigmas

    def __call__(self, n, do_append_zero=True, flip=False, return_idx=False):
        sigmas, idx = self.get_sigmas(n, return_idx=True)
        return _finish(sigmas, idx, append_zero if do_append_zero else None, flip, return_idx)
