"""Noise-level discretization (counterpart of scail_tpu/diffusion/discretization.py).

Host-side numpy: the sigma ladder is a handful of constants per run.
"""

from __future__ import annotations

import numpy as np

from scail_tpu_torch.utils.registry import register


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


@register(alias="sgm.modules.diffusionmodules.discretizer.RFDiscretization")
class RFDiscretization:
    """Rectified-flow sigmas in (0, 1]."""

    def __init__(self, num_timesteps: int = 1000, reverse: bool = False,
                 shift_scale: float = 1.0):
        self.num_timesteps = num_timesteps
        self.reverse = reverse
        grid = np.linspace(1, 0, num_timesteps + 1) if reverse else np.linspace(0, 1, num_timesteps + 1)
        self.sigmas = grid[1:]

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            sigmas = self.sigmas[generate_roughly_equally_spaced_steps(n, self.num_timesteps)]
        elif n == self.num_timesteps:
            sigmas = self.sigmas
        else:
            raise ValueError(n)
        return np.flip(sigmas, 0).astype(np.float32)

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            tail = np.ones((1,), sigmas.dtype) if self.reverse else np.zeros((1,), sigmas.dtype)
            sigmas = np.concatenate([sigmas, tail])
        return np.flip(sigmas, 0).copy() if flip else sigmas
